"""Serving: sampling, the byte and BPE tokenizers, the continuous-batching engine
on the paged KV pool, the model glue and the HTTP app."""
