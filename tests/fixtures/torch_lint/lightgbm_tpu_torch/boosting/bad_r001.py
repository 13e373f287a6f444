import torch


class GBDT:
    def __init__(self):
        self.score = torch.zeros(8)

    def _part_start(self, it):
        g = self.score - 1.0
        if (g > 0).any():                      # R001: __bool__ on a tensor
            g = g * 2
        self.score.copy_(g)
