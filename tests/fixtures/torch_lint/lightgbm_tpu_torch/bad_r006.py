import torch

BINS = torch.arange(256)                       # R006: a tensor at import
if torch.cuda.is_available():                  # R006: CUDA at import
    pass
