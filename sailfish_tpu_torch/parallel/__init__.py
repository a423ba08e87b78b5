"""Multi-process and multi-device execution: the data-parallel step
(dist.py), the sharded index (shardidx.py) and the `--numShards N`
launcher (launcher.py)."""

__all__ = ["make_mesh", "distributed_quant_step"]


def __getattr__(name):
    # dist.py is imported on first use, so `python -m
    # sailfish_tpu_torch.parallel.dist` does not find it imported already
    if name in __all__:
        from . import dist

        return getattr(dist, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
