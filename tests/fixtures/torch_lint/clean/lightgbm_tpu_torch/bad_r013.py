from lightgbm_tpu_torch.parallel.comm import host_allgather


def publish(rank, value, stored):
    stored.get(rank)
    return host_allgather(value)
