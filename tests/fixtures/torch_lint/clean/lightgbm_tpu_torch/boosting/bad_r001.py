import torch


class GBDT:
    def __init__(self):
        self.score = torch.zeros(8)

    def _part_start(self, it):
        g = self.score - 1.0
        g = torch.where((g > 0).any(), g * 2, g)
        self.score.copy_(g)
