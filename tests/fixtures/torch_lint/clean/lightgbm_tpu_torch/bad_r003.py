import numpy as np
import torch


def channels(g, h):
    return torch.stack([g.float(), h.float()])


def offsets(n, dev):
    return torch.as_tensor(np.zeros(n, np.float32), device=dev)
