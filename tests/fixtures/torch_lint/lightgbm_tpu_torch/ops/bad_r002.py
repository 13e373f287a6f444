import torch


def leaf_total(values):
    t = torch.as_tensor(values).sum()
    return t.item()                            # R002: a host read
