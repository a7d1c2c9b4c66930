"""The rank side of tests/test_torch_evolve_group.py: the functions
`parallel.mesh.spawn` runs in each rank.  Imports torch and the port only,
so that a rank starts without JAX.

Each rank seeds the global `random` differently (rank 0 as the one
process does): the GA's parent choice draws from it, so a group that let
any rank but 0 mutate would part from the one process."""
import random


def stub_fitness(h):
    """A fitness of the hyp alone, the same on every rank."""
    return round(h["lr0"] * 10 + h["momentum"] - h["weight_decay"] * 100, 5)


def ga_case(mesh, base, out_dir, generations, seed=123):
    """`evolve` with `stub_fitness` in the group: (best hyp, every hyp
    this rank trained, in order)."""
    from dmayolo_tpu_torch.train.evolve import evolve

    random.seed(seed if mesh is None or mesh.rank == 0 else seed + 1000 * mesh.rank)
    seen = []

    def train_fn(h):
        seen.append(dict(h))
        return stub_fitness(h)

    best = evolve(train_fn, base, generations=generations, out_dir=out_dir, seed=0, mesh=mesh)
    return best, seen


def cli_case(mesh, argv, seed=123):
    """`cli.train` with `argv` (an `--evolve` run) on this rank of the
    group: what `_main` returns (the best hyp)."""
    import torch

    from dmayolo_tpu_torch.cli import train as ptrain

    torch.set_num_threads(1)
    random.seed(seed if mesh is None or mesh.rank == 0 else seed + 1000 * mesh.rank)
    return ptrain._main(ptrain.build_parser().parse_args(argv), mesh)


def group_checks(mesh, ga, cli):
    """Both cases in one launch: {"ga": ..., "cli": ...}."""
    return {"ga": ga_case(mesh, **ga), "cli": cli_case(mesh, **cli)}
