"""torch.cuda.max_memory_allocated() over the whole run (GiB): the card
memory a user of this traffic needs."""


def read(run):
    return run.memory_peak_bytes / 2**30
