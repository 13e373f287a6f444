import torch

CPU = torch.device("cpu")
TINY = torch.finfo(torch.float32).tiny


def bins():
    return torch.arange(256)
