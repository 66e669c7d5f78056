"""recompile-hazard, torch twin of recompile_bad.py: the same lines flag."""
import functools

import torch


def forward(tokens, width):
    return tokens


_compiled = torch.compile(forward)
_named = torch.compile(forward, dynamic=False)
_partial = functools.partial(torch.compile, mode="reduce-overhead")(forward)


def serve(req):
    out = _compiled(req.tokens, len(req.prompt_tokens))  # L17: len()
    out = _named(req.tokens, width=int(req.width))       # L18: int() kwarg
    out = _partial(req.tokens, len(req.tokens))          # L19: via partial
    return out


class Engine:
    def build(self):
        self._fwd = torch.compile(forward)

    def step(self, request):
        # attribute-held wrapper, len() is taint-transparent
        return self._fwd(request.tokens, len(request.tokens))   # L29
