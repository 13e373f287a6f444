import torch


class GBDT:
    def __init__(self, dev):
        self.dev = dev
        self.flags = torch.zeros(3)
        self.half = torch.full((), 0.5, device=dev)

    def _part_start(self, it):
        self.flags[0].copy_(self.half)
        self.flags[1:].fill_(1.0)
        self.flags.copy_(self.flags.to(torch.float32))
