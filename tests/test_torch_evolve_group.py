"""`--evolve` in a group of ranks (dmayolo_tpu_torch/train/evolve.py,
cli/train.py), on the CPU: one gloo launch of two ranks
(`parallel.mesh.spawn`; the rank side is tests/torch_evolve_ranks.py),
beside one process and JAX's GA.

- The GA with a fitness of the hyp alone, 4 generations: every rank
  trains the same hyps as one process, in the same order, and returns
  the same best; `evolve.csv` and `hyp_evolve.yaml` are written once,
  by rank 0, and equal JAX's `evolve` byte for byte.  Rank 1's global
  `random` is seeded apart, so that a mutation on any rank but 0 would
  show.
- `cli.train --evolve 2` (the tiny model at 64 px, one epoch a
  generation) under the group: it no longer raises, every rank returns
  the same best hyp, `evolve.csv` has one row a generation, and its hyps
  are those of the same command in one process (with one row in
  `evolve.csv` the parent choice cannot differ; the fitness of two ranks'
  global step may, within `DIST_EVAL_TOL`).
"""
import csv
import random
import shutil

import numpy as np
import pytest
import yaml

import torch_evolve_ranks as ranks
from dmayolo_tpu.train import evolve as jevolve
from dmayolo_tpu_torch.data.synthetic import generate
from dmayolo_tpu_torch.parallel import mesh as pmesh
from dmayolo_tpu_torch.train.trainer import load_hyp

from test_torch_model import small_cfg
from torch_train_common import one_torch_thread  # noqa: F401

DIST_EVAL_TOL = 1e-4  # chip_smoke.py's bound on two ranks' eval against one process
GENERATIONS, CLI_GENERATIONS = 4, 2
IMG = 64


def _cli_argv(root, data, cfg, name):
    return ["--cfg", cfg, "--data", data, "--epochs", "1", "--batch-size", "8", "--imgsz",
            str(IMG), "--project", str(root / "runs"), "--name", name, "--exist-ok",
            "--workers", "1", "--noautoanchor", "--fp32", "--evolve", str(CLI_GENERATIONS),
            "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evolve_group")
    data = str(generate(str(root / "data"), n_train=8, n_val=4, img_size=IMG, seed=1))
    cfg = root / "tiny.yaml"
    tiny = small_cfg()
    tiny["nc"] = 3
    cfg.write_text(yaml.safe_dump(tiny))
    base = load_hyp("scratch")
    ga = dict(base=base, out_dir=str(root / "ga_w2"), generations=GENERATIONS)
    cli = dict(argv=_cli_argv(root, data, str(cfg), "w2"))
    got = pmesh.spawn(ranks.group_checks, 2, args=(ga, cli), device="cpu", threads=1,
                      timeout=pmesh.COLLECTIVE_TIMEOUT_S)
    one_ga = ranks.ga_case(None, base, str(root / "ga_w1"), GENERATIONS)
    one_cli = ranks.cli_case(None, _cli_argv(root, data, str(cfg), "w1"))
    random.seed(123)  # as rank 0 and the one process
    jevolve.evolve(ranks.stub_fitness, base, generations=GENERATIONS,
                   out_dir=str(root / "ga_jax"), seed=0)
    yield dict(root=root, got=got, one_ga=one_ga, one_cli=one_cli)
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("rank", [0, 1])
def test_ga_ranks_train_the_one_process_hyps(runs, rank):
    best, seen = runs["got"][rank]["ga"]
    one_best, one_seen = runs["one_ga"]
    assert len(seen) == GENERATIONS
    assert seen == one_seen
    assert best == one_best


@pytest.mark.parametrize("name", ["evolve.csv", "hyp_evolve.yaml"])
def test_ga_files_written_once_as_jax(runs, name):
    root = runs["root"]
    ours = (root / "ga_w2" / name).read_text()
    assert ours == (root / "ga_jax" / name).read_text()
    assert ours == (root / "ga_w1" / name).read_text()
    if name == "evolve.csv":
        assert len(ours.splitlines()) == 1 + GENERATIONS


def _rows(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def test_cli_evolve_in_a_group(runs):
    root = runs["root"]
    best = [r["cli"] for r in runs["got"]]
    assert best[0] == best[1]
    keys, w2 = _rows(root / "runs" / "w2" / "evolve.csv")
    keys1, w1 = _rows(root / "runs" / "w1" / "evolve.csv")
    assert keys == keys1 and len(w2) == len(w1) == CLI_GENERATIONS
    np.testing.assert_array_equal(w2[:, 1:], w1[:, 1:])  # the hyps
    np.testing.assert_allclose(w2[:, 0], w1[:, 0], atol=DIST_EVAL_TOL, rtol=0)  # fitness
    assert set(best[0]) == set(runs["one_cli"])
    assert (root / "runs" / "w2" / "hyp_evolve.yaml").exists()
