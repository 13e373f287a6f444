import torch


def _order(leaf_id):
    return torch.argsort(leaf_id, stable=True)


def set_up(leaf_id):
    return _order(leaf_id)


class TreeGrower:
    def wave(self):
        counts = torch.bincount(self.leaf_id)
        self.starts.copy_(torch.cumsum(counts, 0) - counts)
