"""recompile-hazard, the torch twin of analysis_fixtures/recompile_good.py:
bucketing breaks the taint; config-derived and literal scalars are fine,
and so is a per-request tensor (its value does not recompile)."""
import torch


def forward(tokens, width):
    return tokens


_compiled = torch.compile(forward)
_plain = torch.compile(forward, fullgraph=True)


def _bucket_for(n):
    b = 16
    while b < n:
        b *= 2
    return b


def serve(req, config):
    # routed through the bucketing helper: sanctioned
    out = _compiled(req.tokens, _bucket_for(len(req.tokens)))
    # config-derived scalar: compiles once per deployment, not per request
    out = _compiled(req.tokens, config.max_seq)
    # literal scalar
    out = _compiled(req.tokens, 128)
    # a tensor argument only
    return _plain(out, req.tokens)
