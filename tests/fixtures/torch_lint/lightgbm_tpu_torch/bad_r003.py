import numpy as np
import torch


def channels(g, h):
    return torch.stack([g.float(), h])         # R003: one input uncast


def offsets(n, dev):
    return torch.as_tensor(np.zeros(n), device=dev)   # R003: float64
