import torch


class GBDT:
    def __init__(self, dev):
        self.dev = dev
        self.flags = torch.zeros(3)

    def _part_start(self, it):
        self.flags[0] = 0.5                    # R009: a host scalar
        w = torch.ones(3).to(self.dev)         # R009: a device move
        self.flags.copy_(w)
