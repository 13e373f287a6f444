import numpy as np
import torch

from lightgbm_tpu_torch.robustness import allowed_host_sync


class Engine:
    def encode(self, X):
        return np.asarray(X, np.float32)

    @allowed_host_sync("the dispatch's one result wait")
    def dispatch(self, X):
        out = torch.as_tensor(self.encode(X)).sum(dim=1)
        return out.cpu()
