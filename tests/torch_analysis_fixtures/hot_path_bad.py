"""hot-path-purity, torch twin of hot_path_bad.py: the same lines flag."""
import time
import datetime
import numpy as np
import torch
import torch.cuda

from gofr_tpu_torch.analysis import hot_path


class Engine:
    @hot_path
    def dispatch(self, state, logits):
        t0 = time.time()                      # L14: wall clock
        host = state.cpu().numpy()            # L15: d2h copies
        n = int(torch.argmax(logits))         # L16: coerce a tensor
        torch.cuda.synchronize()              # L17: device sync
        self.done_event.synchronize()         # L18: event sync
        v = state.item() + len(state.to("cpu").tolist())  # L19: syncs
        self.metrics.increment_counter("app_x")   # L20: metric write
        self.logger.info("dispatched")        # L21: logging
        when = datetime.datetime.now()        # L22: wall clock
        return host, n, v, t0, when, np

    @hot_path
    def step(self):
        return self._helper()

    def _helper(self):
        # not decorated, but statically called from a @hot_path root:
        # the closure walk must still reach it
        return time.time(), self.lengths.tolist()   # L32: via closure
