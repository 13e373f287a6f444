import torch


class GBDT:
    def __init__(self):
        self.score = torch.zeros(8)

    def _part_tree_end(self, k):
        self.score = self.score + 1.0          # R005: a new address
