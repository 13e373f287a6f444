import torch


def _order(leaf_id):
    return torch.argsort(leaf_id, stable=True)   # R007: per wave


class TreeGrower:
    def wave(self):
        self.perm = _order(self.leaf_id)
