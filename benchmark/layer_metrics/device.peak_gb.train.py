"""device: the peak of allocated device memory over the window
(``max_memory_allocated`` after ``reset_peak_memory_stats``), GB."""
from benchmark.readers import peak_gb


def read(ctx):
    return peak_gb(ctx, 'train')
