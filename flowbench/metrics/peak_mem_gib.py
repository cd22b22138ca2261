"""peak_mem_gib: torch.cuda.max_memory_allocated over the window, in GiB
(the most over the cards on several)."""


def read(rec):
    return rec.peak_mem_bytes / 2**30 if rec.peak_mem_bytes else None
