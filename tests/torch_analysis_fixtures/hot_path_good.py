"""hot-path-purity, the torch twin of analysis_fixtures/hot_path_good.py:
none of this may be flagged."""
import time
import numpy as np
import torch

from gofr_tpu_torch.analysis import hot_path, hot_path_boundary


class Engine:
    @hot_path
    def dispatch(self, state, logits):
        t0 = time.perf_counter()        # sanctioned timer
        staged = torch.as_tensor(state).to(self.device, non_blocking=True)
        buf = np.zeros(4, np.int32)     # host alloc, no device involved
        n = int(buf[0])                 # coerces a HOST value: legal
        self._retire(n)                 # boundary: walk stops there
        return staged, t0, logits.to(torch.bfloat16)

    @hot_path_boundary("terminal path: host assembly at retire is the design")
    def _retire(self, n):
        # inside a boundary anything goes — this is the point of it
        self.metrics.increment_counter("app_engine_retires")
        self.logger.info("retired", n=n)
        self.tokens.cpu().tolist()
        torch.cuda.synchronize()
        return time.time()

    def cold_path(self):
        # undecorated and unreachable from a @hot_path root: not scanned
        self.metrics.increment_counter("app_cold")
        return time.time(), self.tokens.cpu().numpy()
