import torch

from lightgbm_tpu_torch.robustness import allowed_host_sync


def leaf_total(values):
    return torch.as_tensor(values).sum()


@allowed_host_sync("the run's one total, read after training")
def leaf_total_host(values):
    t = torch.as_tensor(values).sum()
    return t.item()
