"""Faults planted in the port's sharded BA, each of which a check must
catch (tests/test_torch_parallel.py, chip_smoke.py). Each is a rank setup
function for parallel/sharded_ba.py::spawn_sharded_global_ba: module
level, so that a spawned rank can import it."""


def skip_point_reduce(rank: int, world: int):
    """Rank 1 keeps its own per-point partial sums: it still joins every
    all-reduce (so the collectives stay in step) but discards the reduced
    per-point part."""
    if rank != 1:
        return
    from object_slam_tpu_torch.parallel import sharded_ba
    reduce = sharded_ba.ObsShard.reduce

    def partial(self, kf=(), pt=(), cost=()):
        k, _, c = reduce(self, kf=kf, pt=pt, cost=cost)
        return k, [p.clone() for p in pt], c
    sharded_ba.ObsShard.reduce = partial
