"""Training CLI, with the JAX package's flags.

Port of `dmayolo_tpu/cli/train.py`.  Each run writes `opt.yaml` and
`hyp.yaml` beside its checkpoints; `--resume [ckpt|auto]` restores them
and goes on in the same directory; `--batch-size -1` picks the batch from
the card's memory (`train/autobatch.py`); `--evolve N` runs the
hyperparameter search (`train/evolve.py`) and plots it (`plot_evolve`,
where matplotlib imports).  `--remat` turns on by itself at `--imgsz` 1024
and above (`--no-remat` keeps it off).  `--ckpt-async` writes the
checkpoints (the same JAX `.npz`) on a background thread
(`utils/async_ckpt.py`).  Under torchrun (`python -m torch.distributed.run
--nproc-per-node N`, the reference's DDP launch) each rank trains on
`cuda:LOCAL_RANK` (`parallel/mesh.py`): `--batch-size` is the global batch,
each rank runs its share of the global step, and rank 0 writes the run
directory; `--batch-size -1` probes each device's memory with its share.
Without torchrun one process trains.  `--sync-bn` changes nothing: BN
always takes the global batch's moments, as in JAX.  `--spatial-shard`
runs as JAX's does: it passes `spatial=True` to a `Trainer` on the
default mesh, whose every rank is on the data axis, so nothing is split
along H (the line it prints says so); H-sharded training is the Python
API's, `Trainer(mesh=make_mesh(n_data, n_spatial), spatial=True)`.
`--evolve` under torchrun: rank 0 mutates and writes `evolve.csv`, every
rank trains each generation on the group (`train/evolve.py`).  `main`
returns the best fitness, or the evolved hyp.

The flagship recipe (train.sh:5-9):
    python -m dmayolo_tpu_torch.cli.train --imgsz 1536 --adam --batch-size 4 \\
        --epochs 200 --data VisDrone.yaml --hyp visdrone \\
        --cfg ablation-ca-scconv-sppfcspc.yaml --fastload --device-aug --remat
    python -m torch.distributed.run --nproc-per-node 4 -m dmayolo_tpu_torch.cli.train \\
        --batch-size 16 ...
"""
from __future__ import annotations

import argparse
from pathlib import Path

import yaml

from .common import increment_path, load_hyp, resolve_config


def build_parser():
    p = argparse.ArgumentParser("dmayolo-train")
    # not argparse-required: a bare `--resume <ckpt>` restores cfg and data
    # from the run's own opt.yaml; checked after parsing
    p.add_argument("--cfg", type=str, default=None, help="model yaml")
    p.add_argument("--data", type=str, default=None, help="dataset yaml")
    p.add_argument("--hyp", type=str, default="scratch", help="hyp yaml")
    p.add_argument("--weights", type=str, default="", help="pretrained npz checkpoint")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16,
                   help="-1 = autobatch from the card's memory")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640, dest="imgsz")
    p.add_argument("--adam", action="store_true")
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--assignment", type=str, default="anchor", choices=["anchor", "tal"])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--project", type=str, default="runs/train")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--resume", type=str, default="", nargs="?", const="auto")
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noautoanchor", action="store_true")
    p.add_argument("--ckpt-async", action="store_true",
                   help="write checkpoints on a background thread (the same .npz; the "
                        "JAX package writes an Orbax directory, which the port does not)")
    p.add_argument("--device-aug", action="store_true",
                   help="HSV jitter and lr-flip inside the train step on the card "
                        "(the host ships raw uint8)")
    p.add_argument("--fastload", action="store_true",
                   help="accepted; changes nothing: the port has one decode path, "
                        "its host library (csrc/host/imgio.cpp), which already "
                        "decodes and resizes as native/fastload.cpp does")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer's activations in the backward "
                        "(torch.utils.checkpoint): about one more forward for "
                        "less memory. On by itself at --imgsz >= 1024; "
                        "--no-remat opts out")
    p.add_argument("--no-remat", action="store_true",
                   help="disable the automatic remat at imgsz >= 1024")
    p.add_argument("--max-targets", type=int, default=128)
    p.add_argument("--fp32", action="store_true", help="disable bf16 compute")
    p.add_argument("--spatial-shard", action="store_true",
                   help="spatial=True to the Trainer, whose default mesh is data-only "
                        "(as in JAX: nothing is split along H)")
    p.add_argument("--train-ungrouped", action="store_true",
                   help="also optimize params the reference leaves out")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default; raises without it) or cpu")
    p.add_argument("--evolve", type=int, nargs="?", const=300, default=0,
                   help="evolve hyperparameters for N generations")
    p.add_argument("--multi-scale", action="store_true", help="bucketed random train sizes")
    p.add_argument("--single-cls", action="store_true", help="train as single-class")
    p.add_argument("--cache", type=str, nargs="?", const="ram", default=None,
                   choices=["ram", "disk"], help="cache images in ram or on disk")
    p.add_argument("--rect", action="store_true", help="rectangular training")
    p.add_argument("--quad", action="store_true", help="quad dataloader (collate_fn4)")
    p.add_argument("--nosave", action="store_true", help="only save final checkpoint")
    p.add_argument("--noval", action="store_true", help="only validate final epoch")
    p.add_argument("--label-smoothing", type=float, default=0.0,
                   help="label smoothing epsilon (overrides hyp)")
    p.add_argument("--freeze", type=int, default=0,
                   help="freeze first N layers (backbone=10, all=24)")
    p.add_argument("--save-period", type=int, default=-1,
                   help="save epoch{N}.npz every N epochs (<1 disables)")
    p.add_argument("--sync-bn", action="store_true",
                   help="accepted for parity; does nothing: BN always takes the moments "
                        "of the global batch, over every rank (as JAX under pjit)")
    p.add_argument("--image-weights", action="store_true", help="class-mAP weighted image sampling")
    p.add_argument("--accumulate", type=int, default=0,
                   help="grad-accumulation factor (0 = auto round(64/bs))")
    p.add_argument("--no-accum-ramp", action="store_true",
                   help="disable the reference's warmup accumulate ramp "
                        "1->64/bs and keep a fixed cadence")
    return p


def get_latest_run(search_dir: str = "runs/train"):
    """Most recent last.npz under search_dir."""
    runs = sorted(Path(search_dir).rglob("last.npz"), key=lambda p: p.stat().st_mtime)
    return runs[-1] if runs else None


def resolve_remat(remat: bool, no_remat: bool, imgsz: int) -> bool:
    """Remat policy: an explicit flag wins; otherwise on at >= 1024 px."""
    if remat:
        return True
    if no_remat:
        return False
    return imgsz >= 1024


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if not opt.resume and not (opt.cfg and opt.data):
        build_parser().error("--cfg and --data are required unless --resume")
    from ..parallel import mesh as pm

    if opt.spatial_shard:
        print("--spatial-shard: the default mesh puts every device on the data axis, so "
              "images are not split along H (as in JAX); pass a (data, spatial) mesh to "
              "Trainer(mesh=make_mesh(n_data, n_spatial), spatial=True) for that")
    if not pm.under_torchrun():
        return _main(opt)
    mesh = pm.join_torchrun(device=opt.device)
    try:
        return _main(opt, mesh)
    finally:
        pm.close_group()


def _main(opt, mesh=None):
    from .common import setup_device

    main_rank = mesh is None or mesh.is_main
    if mesh is None:
        setup_device(opt.device)

    # resolved before the opt.yaml dump below, so the run's config records
    # the remat actually used (resume re-derives from the saved opt)
    if resolve_remat(opt.remat, opt.no_remat, opt.imgsz) and not opt.remat:
        opt.remat = True
        if main_rank:
            print(f"imgsz {opt.imgsz} >= 1024: enabling --remat (smaller at high res; "
                  "--no-remat to opt out)")

    if opt.resume:
        # the interrupted run's own options and directory
        last = get_latest_run(opt.project) if opt.resume == "auto" else Path(opt.resume)
        if last is None or not last.exists():
            raise FileNotFoundError(f"--resume: no checkpoint found ({opt.resume})")
        out = last.parent
        opt_file = out / "opt.yaml"
        if opt_file.exists():
            with open(opt_file, errors="ignore") as f:
                saved = yaml.safe_load(f)
            keep = {"resume", "device"}  # the current invocation wins for these
            for k, v in saved.items():
                if k not in keep and hasattr(opt, k):
                    setattr(opt, k, v)
        opt.resume = str(last)
        hyp_file = out / "hyp.yaml"
        hyp = load_hyp(str(hyp_file)) if hyp_file.exists() else load_hyp(opt.hyp)
        print(f"resuming {last} (options restored from {opt_file})")
    else:
        hyp = load_hyp(opt.hyp)
        out = None
        if main_rank:
            out = increment_path(f"{opt.project}/{opt.name}", exist_ok=opt.exist_ok)
            out.mkdir(parents=True, exist_ok=True)
            with open(out / "hyp.yaml", "w") as f:
                yaml.safe_dump(dict(hyp), f, sort_keys=False)
            with open(out / "opt.yaml", "w") as f:
                yaml.safe_dump({k: v for k, v in vars(opt).items() if k != "device"}, f,
                               sort_keys=False)
        if mesh is not None:  # rank 0's run directory
            out = mesh.broadcast_object(out)

    if opt.batch_size == -1:
        # every rank probes its own device; rank 0's choice is the run's
        opt.batch_size = autobatch_size(opt, hyp, mesh)
        if mesh is not None:
            opt.batch_size = mesh.broadcast_object(opt.batch_size)

    if opt.evolve:
        from ..train.evolve import evolve

        def train_once(h):
            return _make_trainer(opt, h, str(out / "evolve_run"), mesh).train()

        # in a group rank 0 alone mutates and writes; every rank trains
        best = evolve(train_once, hyp, generations=opt.evolve, out_dir=str(out),
                      autoanchor=not opt.noautoanchor, mesh=mesh)
        if not main_rank:
            return best
        print("evolved hyp:", best)
        try:
            from ..utils.plots import plot_evolve

            png = plot_evolve(out / "evolve.csv")
            print(f"evolve plot -> {png}")
        except Exception as e:  # plotting must never fail the run
            print(f"plot_evolve failed: {type(e).__name__}: {e}")
        return best

    trainer = _make_trainer(opt, hyp, str(out), mesh)
    if main_rank:
        print(f"training -> {out}")
    return trainer.train()


def autobatch_size(opt, hyp, mesh=None) -> int:
    """`--batch-size -1`: the global batch from the card's memory, probed
    on the step the Trainer will run (accumulate, device_aug, remat,
    optimizer) at this rank's share of each batch size, a multiple of the
    world size; the default 16 on the CPU."""
    import torch

    from ..data.datasets import check_dataset
    from ..graph import DetectionModel
    from ..train.autobatch import find_train_batch_size
    from ..train.loss import ComputeLoss
    from ..train.tal import ComputeLossTAL
    from .common import setup_device

    data = check_dataset(opt.data)
    model = DetectionModel(resolve_config(opt.cfg, "models"), nc=data["nc"],
                           device=setup_device(opt.device) if mesh is None else mesh.device)
    model.init_with_priors(torch.Generator().manual_seed(0))
    h = dict(hyp)
    if opt.assignment == "tal":
        loss = ComputeLossTAL(model.stride, nc=data["nc"], hyp=h)
    else:
        loss = ComputeLoss(model.head.anchors, h, nc=data["nc"])
    return find_train_batch_size(
        model, loss, h, img_size=opt.imgsz,
        dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        max_targets=opt.max_targets, remat=opt.remat, adam=opt.adam,
        device_aug=({"hgain": h.get("hsv_h", 0.015), "sgain": h.get("hsv_s", 0.7),
                     "vgain": h.get("hsv_v", 0.4), "fliplr": h.get("fliplr", 0.5)}
                    if opt.device_aug else None),
        accumulate=int(opt.accumulate) if opt.accumulate else None,
        world=1 if mesh is None else mesh.world)


def _make_trainer(opt, hyp, out_dir, mesh=None):
    import torch

    from ..train.trainer import Trainer

    hyp = dict(hyp)
    if opt.label_smoothing:
        hyp["label_smoothing"] = opt.label_smoothing
    return Trainer(
        resolve_config(opt.cfg, "models"),
        data=opt.data,
        hyp=dict(hyp),
        epochs=opt.epochs,
        batch_size=opt.batch_size,
        img_size=opt.imgsz,
        assignment=opt.assignment,
        adam=opt.adam,
        linear_lr=opt.linear_lr,
        workers=opt.workers,
        out_dir=out_dir,
        max_targets=opt.max_targets,
        dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        seed=opt.seed,
        patience=opt.patience,
        train_ungrouped=opt.train_ungrouped,
        autoanchor=not opt.noautoanchor,
        multi_scale=opt.multi_scale,
        image_weights=opt.image_weights,
        single_cls=opt.single_cls,
        cache_images=opt.cache,
        resume_from=opt.resume if opt.resume and opt.resume != "auto" else None,
        pretrained=opt.weights or None,
        accumulate=opt.accumulate or None,
        accum_ramp=not opt.no_accum_ramp,
        device_aug=opt.device_aug,
        rect=opt.rect,
        quad=opt.quad,
        nosave=opt.nosave,
        noval=opt.noval,
        freeze=opt.freeze,
        save_period=opt.save_period,
        remat=opt.remat,
        ckpt_async=opt.ckpt_async,
        device=opt.device if mesh is None else mesh.device,
        mesh=mesh,
        spatial=opt.spatial_shard,
    )


if __name__ == "__main__":
    main()
