"""Seconds this run's process spent loading the port's kernel libraries
(``nvcc`` builds and ``dlopen``), the warm-up call's loads: the load
seconds of ``repro_torch.kernels._build.cache_stats()``.  Nothing where no
library was loaded, or where the program keeps no such count."""


def read(ctx):
    from repro_torch.kernels import _build

    stats = _build.cache_stats()
    load_s = getattr(stats, "load_s", None)
    if load_s is None or not sum(stats.snapshot().values()):
        return None
    return load_s
