"""Model families of the port: Llama-3 (``llama.py``), the Mixtral-style
MoE (``moe.py``), the JAX parameter converter (``convert.py``) and local
Hugging Face checkpoints (``hf_checkpoint.py``)."""
