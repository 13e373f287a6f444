import torch


class Engine:
    def dispatch(self, X):
        out = torch.as_tensor(X).sum(dim=1)
        torch.cuda.synchronize()               # R011
        return out.cpu()                       # R011
