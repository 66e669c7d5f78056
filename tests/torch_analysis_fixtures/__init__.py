# Torch twins of tests/analysis_fixtures/ for the port's analyzer
# (tests/test_torch_analysis.py): each <rule>_bad.py seeds the PyTorch
# spellings of its JAX twin's violations at the JAX twin's lines, each
# <rule>_good.py is silent. PARSED by the analyzer, never imported or
# executed; not linted by the repo runs (tests/ is excluded).
