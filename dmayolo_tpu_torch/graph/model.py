"""Model assembly from the YAML config format.

Port of `dmayolo_tpu/graph/model.py::DetectionModel`: the same
`[from, number, module, args]` rows, depth and width gains, channel rules
and save list, and the same `LayerSpec` record of each layer.  The stride
probe is a forward on PyTorch's `meta` device (shapes only, no memory),
the analogue of the JAX `eval_shape` probe.
"""
from __future__ import annotations

import contextlib
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import yaml

from ..core.nms import NEG_INF, _top_k_candidates, nms_from_topk, nms_parts
from ..nn.activations import AconC, MetaAconC
from ..nn.blocks import AdConcat2, Sum
from ..nn.fuse import fuse_model
from ..nn.fusion import AdaptAdd2
from ..nn.heads import Detect, TDetect
from ..nn.hornet import HorBlock
from ..nn.primitives import BatchNorm2d, Conv2d, LayerNorm, Linear, Sequential, remat_layer
from ..nn.transformer import MultiheadAttention, WindowAttention
from ..parallel import spatial
from ..utils.device import resolve_device
from .registry import INSERT_N, REGISTRY, WIDTH_GAIN

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs" / "models"
STRIDE_PROBE = 256  # input side of the shape-only forward that finds the strides
# the modules that own parameters or statistics; `reset_parameters` fills
# them after the meta-device build
INITIALISED = (Conv2d, BatchNorm2d, Linear, LayerNorm, MultiheadAttention, WindowAttention,
               AdConcat2, AdaptAdd2, HorBlock, Sum, AconC, MetaAconC)


def model_config(name: str) -> Path:
    """Path of a model yaml shipped with the port, by bare name."""
    path = CONFIG_DIR / (name if name.endswith(".yaml") else f"{name}.yaml")
    if not path.exists():
        raise FileNotFoundError(f"no model config {name!r} in {CONFIG_DIR}")
    return path


def make_divisible(x, divisor=8):
    return math.ceil(x / divisor) * divisor


def _eval_arg(a, scope: Dict[str, Any]):
    """Safe stand-in for the reference parser's eval of string args."""
    if not isinstance(a, str):
        return a
    if a in scope:
        return scope[a]
    if a in ("True", "False"):
        return a == "True"
    for conv in (int, float):
        try:
            return conv(a)
        except ValueError:
            pass
    return a  # a plain string such as 'nearest'


class LayerSpec:
    """One parsed yaml row: index, from, registry name, the displayed
    repeat count, the final constructor args and the output channels."""

    def __init__(self, i, f, name, n, args, c2):
        self.i = i
        self.f = f
        self.name = name
        self.n = n
        self.args = args
        self.c2 = c2

    def __repr__(self):
        return f"[{self.i:>3}] from={self.f!s:>12} n={self.n} {self.name:<16} args={self.args}"


def check_anchor_order(anchors: np.ndarray, strides) -> np.ndarray:
    """Flip anchors if their area order disagrees with the stride order."""
    areas = anchors.prod(-1).mean(-1)
    if np.sign(areas[-1] - areas[0]) != np.sign(strides[-1] - strides[0]):
        return anchors[::-1].copy()
    return anchors


class DetectionModel(nn.Module):
    """YAML-driven detector: backbone + head + Detect or TDetect.

    Takes images (B, H, W, 3) and returns the raw head, a list of
    (B, ny, nx, na, no) for Detect, (B, ny, nx, 4 * 16 + nc) for TDetect.
    Inside `parallel.spatial.spatial_scope(mesh)` the images are this
    rank's rows of each image (`parallel.mesh.shard_batch(spatial=True)`),
    every layer runs its spatial form, and the raw head comes back whole
    on every rank of the spatial group.
    Built on `device` (None means CUDA, and raises when CUDA is missing)
    with deterministic weights from seed 0, in eval mode; call
    `init_with_priors(generator)` for seeded weights with the head priors,
    or `load_state_dict` (see `utils/weights.py`).  `anchors` overrides the
    yaml's: pairs per level, or a number n for round(n) placeholder anchors
    a level, which autoanchor replaces (`train/autoanchor.py`).

    `model.train()` is the JAX `apply(train=True)`: every BN normalises
    with its batch moments and updates its running statistics in place,
    so the JAX `(raw, new_stats)` pair is the raw head and the module's
    buffers.  `model.eval()` switches back.  With `remat` set, a forward
    in train mode that records gradients recomputes each graph layer's
    activations in the backward (the JAX `apply(remat=True)`; see
    `nn/primitives.py::remat_layer`)."""

    def __init__(self, cfg: Union[str, Path, dict], ch: int = 3,
                 nc: Optional[int] = None, anchors=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(cfg, (str, Path)):
            with open(cfg, errors="ignore") as f:
                self.yaml = yaml.safe_load(f)
            self.yaml_file = str(cfg)
        else:
            self.yaml = dict(cfg)
            self.yaml_file = "<dict>"
        self.ch = self.yaml.get("ch", ch)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        if anchors:
            self.yaml["anchors"] = (round(anchors) if isinstance(anchors, (int, float))
                                    else anchors)
        self.nc = self.yaml["nc"]
        self.fused = False
        self.remat = False
        self.lazy_tails = 0  # serving tails that took the lazy route
        self._convs = None  # {name: Conv2d}, for `int8_convs`

        with torch.device("meta"):
            self.model = nn.ModuleList(self._parse())
            self.eval()
            # stride probe: shapes of the raw head for an s x s input
            s = STRIDE_PROBE
            shapes = [o.shape for o in self.forward(
                torch.empty(1, s, s, self.ch), torch.float32)]
        head = self.head
        if isinstance(head, (Detect, TDetect)):
            self.stride = np.asarray([s / sh[1] for sh in shapes], np.float32)
            head.stride = self.stride
            if isinstance(head, Detect):
                anc = head.anchors / self.stride.reshape(-1, 1, 1)
                head.anchors = check_anchor_order(anc, self.stride)
        else:
            self.stride = np.asarray([32.0], np.float32)
        self.to_empty(device=dev)
        self.to(memory_format=torch.channels_last)
        self.reset_parameters(torch.Generator().manual_seed(0))
        self.eval()

    @property
    def head(self) -> nn.Module:
        return self.model[-1]

    # -- config interpretation ----------------------------------------------
    def _parse(self) -> List[nn.Module]:
        d = self.yaml
        anchors, nc = d["anchors"], d["nc"]
        gd, gw = d["depth_multiple"], d["width_multiple"]
        na = (len(anchors[0]) // 2) if isinstance(anchors, list) else anchors
        no = na * (nc + 5)
        scope = {"nc": nc, "anchors": anchors, "None": None}
        layers: List[nn.Module] = []
        self.specs: List[LayerSpec] = []
        save: List[int] = []
        ch = [self.ch]
        for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
            cls = REGISTRY.get(name)
            if cls is None:
                raise KeyError(f"unknown module '{name}' in config (layer {i})")
            args = [_eval_arg(a, scope) for a in args]
            n_disp = n = max(round(n * gd), 1) if n > 1 else n
            if name in WIDTH_GAIN:
                c1, c2 = ch[f], args[0]
                if c2 != no:
                    c2 = make_divisible(c2 * gw, 8)
                args = [c1, c2, *args[1:]]
                if name in INSERT_N:
                    args.insert(2, n)
                    n = 1
            elif name == "nn.BatchNorm2d":
                args = [ch[f]]
                c2 = ch[f]
            elif name in ("Concat", "AdConcat2", "AdConcat3"):
                c2 = sum(ch[x] for x in f)
            elif name in ("ConvMix", "CSPCM"):
                c1, c2 = ch[f], args[0]
                if c2 != no:
                    c2 = make_divisible(c2 * gw, 8)
                args = [c1, c2, *args[1:]]
            elif name in ("AdaptConcat", "AdaptADD"):
                c2 = sum(ch[x] for x in f)
                args = [len(f), *args]
            elif name in ("Adapt_Add2", "Adapt_Add3"):
                c2 = max(ch[x] for x in f)
            elif name == "C3GhostV2":
                c1, c2 = ch[f], args[0]
                if c2 != no:
                    c2 = make_divisible(c2 * gw, 8)
                args = [c1, c2, n, *args[1:]]
                n = 1
            elif name == "Detect":
                args.append([ch[x] for x in f])
                if isinstance(args[1], int):  # 'anchors: N' auto-anchor mode
                    args[1] = [list(range(args[1] * 2))] * len(f)
            elif name == "TDetect":
                args.append([ch[x] for x in f])
            elif name == "Contract":
                c2 = ch[f] * args[0] ** 2
            elif name == "Expand":
                c2 = ch[f] // args[0] ** 2
            elif name == "space_to_depth":
                c2 = 4 * ch[f]
            elif name in ("SMMConv", "DMConv"):
                c1, c2 = ch[f], 4 * args[0]
                args = [c1, args[0]]
            elif name == "DMMConv":
                c1, c2 = ch[f], 5 * args[0]
                args = [c1, args[0]]
            elif name == "DMMConv2":
                c1 = ch[f]
                c2 = args[0] + 4 * c1
                args = [c1, args[0]]
            elif name == "Classify":
                c1, c2 = ch[f], args[0]
                args = [c1, c2, *args[1:]]
            else:
                c2 = ch[f] if isinstance(f, int) else ch[f[0]]
            mod = Sequential(*[cls(*args) for _ in range(n)]) if n > 1 else cls(*args)
            mod.f, mod.i = f, i
            layers.append(mod)
            self.specs.append(LayerSpec(i, f, name, n_disp, args, c2))
            save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
            if i == 0:
                ch = []
            ch.append(c2)
        self.save = sorted(set(save))
        return layers

    # -- execution -------------------------------------------------------------
    def forward(self, x: torch.Tensor, dtype=torch.float32, features=None):
        """Save-list graph execution on images (B, H, W, C); returns the raw
        head.  `dtype` is the compute dtype of every conv.  A `features`
        list gets each layer's (index, registry name, output)."""
        x = x.permute(0, 3, 1, 2)  # NCHW view; channels_last if x is NHWC-contiguous
        y: Dict[int, torch.Tensor] = {}
        remat = self.remat and self.training and torch.is_grad_enabled()
        for mod, spec in zip(self.model, self.specs):
            f = mod.f
            if f != -1:
                x = (y[f % mod.i] if isinstance(f, int)
                     else [x if j == -1 else y[j % mod.i] for j in f])
            spatial.set_layer(f"{mod.i} ({spec.name})")
            x = remat_layer(mod, x, dtype) if remat else mod(x, dtype)
            if mod.i in self.save:
                y[mod.i] = x
            if features is not None:
                features.append((mod.i, spec.name, x))
        if spatial.current() is not None and isinstance(self.head, (Detect, TDetect)):
            # each raw level's rows whole on every spatial rank: decode's
            # grid offsets, NMS and the loss read the whole map
            x = [spatial.gather_h(level, dim=1) for level in x]
        return x

    def apply_with_features(self, x: torch.Tensor, dtype=torch.float32, fused: bool = False):
        """Forward that also returns every layer's output: a list of
        (index, registry name, output), a 4-D output as (B, H, W, C), as
        the JAX `apply_with_features` gives it (the reference's
        --visualize hook, yolo.py:237-238)."""
        feats = []
        self.apply(x, dtype, fused, features=feats)
        return [(i, name, out.permute(0, 2, 3, 1) if torch.is_tensor(out) and out.dim() == 4
                 else out) for i, name, out in feats]

    def apply(self, x: torch.Tensor, dtype=torch.float32, fused: bool = False, features=None,
              quant=None):
        """Forward, as the JAX `apply`: `fused=True` asks for the folded
        weights, so the model must have been through `fuse()`.  `quant`
        ({conv name: input scale}, from `nn/quant.py::calibrate_act_scales`)
        runs those convs on the int8 path for this call."""
        if fused and not self.fused:
            raise ValueError("fused=True needs the BN-folded model: call fuse() first")
        if quant is None:
            return self(x, dtype, features)
        with self.int8_convs(quant):
            return self(x, dtype, features)

    @contextlib.contextmanager
    def int8_convs(self, quant):
        """Within the block, each conv named in `quant` runs its int8 form
        for its scale (`Conv2d.int8_form`, made once a conv and scale)."""
        if self._convs is None:
            self._convs = {name: m for name, m in self.named_modules() if isinstance(m, Conv2d)}
        convs = [self._convs[name] for name in quant]
        try:
            for conv, s_x in zip(convs, quant.values()):
                conv.int8 = conv.int8_form(s_x)
            yield
        finally:
            for conv in convs:
                conv.int8 = None

    # -- weights ---------------------------------------------------------------
    def reset_parameters(self, generator: torch.Generator):
        """Every parameter and statistic afresh, with the JAX package's
        init, drawn from `generator` in module order."""
        for m in self.modules():
            if isinstance(m, INITIALISED):
                m.reset_parameters(generator)

    def init_with_priors(self, generator: torch.Generator):
        """Fresh weights from `generator` plus the detection-head bias
        priors; returns self."""
        self.reset_parameters(generator)
        if isinstance(self.head, (Detect, TDetect)):
            self.head.bias_init()
        return self

    def fuse(self):
        """Fold every BN into its conv, in place; returns self."""
        fuse_model(self)
        self.fused = True
        return self

    def describe(self) -> str:
        """The config, layer count, nc and strides, then one line a layer."""
        lines = [f"{self.yaml_file}: {len(self.model)} layers, nc={self.nc}, "
                 f"stride={self.stride.tolist()}"]
        lines += [repr(s) for s in self.specs]
        return "\n".join(lines)

    # -- decode and serving tail ---------------------------------------------
    def decode(self, raw):
        """Raw head -> (B, N, 5 + nc) decoded predictions, the eval path."""
        return self.head.decode(raw)

    def decode_parts(self, raw, class_mask=None, ref_order: bool = True):
        """Serving decode (see each head's `decode_parts`); TDetect's
        candidates are in their one (y, x) order whatever `ref_order`."""
        if isinstance(self.head, TDetect):
            return self.head.decode_parts(raw, class_mask)
        return self.head.decode_parts(raw, class_mask, ref_order=ref_order)

    def decode_topk(self, raw, k: int = 512, conf_thres: float = 0.25, class_mask=None):
        """Lazy serving decode: the conf gate and top-k on the best-class
        scores, then the boxes of the K survivors only (the head's
        `decode_scores`, `decode_at`; DFL boxes for TDetect).  Equal to
        `decode_parts` followed by `nms_parts`' candidate selection; feed
        it to `nms_from_topk`.
        Returns (top_boxes (B, K, 4), top_scores (B, K), top_cls (B, K))."""
        scores = self.head.decode_scores(raw, class_mask)
        cand = torch.where(scores > conf_thres, scores, torch.full_like(scores, NEG_INF))
        top_scores, top_idx = _top_k_candidates(cand, min(k, cand.shape[1]))
        boxes, cls = self.head.decode_at(raw, top_idx)
        return boxes, top_scores, cls

    def serve_detections(self, raw, conf_thres: float = 0.25,
                         iou_thres: float = 0.45, max_det: int = 300,
                         max_nms: int = 512, backend: str = "matrix",
                         agnostic: bool = False, class_mask=None,
                         ref_order: bool = True):
        """Raw head -> (dets (B, max_det, 6), valid (B, max_det)): decode,
        top-`max_nms` candidates, greedy class-offset NMS.  backend "matrix"
        goes through the CUDA kernel K3, "pallas" through K2 (see
        core/nms.py).

        A TDetect head whose candidates number at least 4 * `max_nms` takes
        the lazy route (`decode_topk`, then `nms_from_topk`: boxes decoded
        for the top-k cells only, counted in `lazy_tails`); every other head
        the eager one (`decode_parts`, then `nms_parts`).  Both give the
        same detections, as in the JAX package."""
        if isinstance(self.head, TDetect):
            n_cand = sum(x.shape[1] * x.shape[2] for x in raw)
            if max_nms * 4 <= n_cand:
                self.lazy_tails += 1
                tb, ts, tc = self.decode_topk(raw, k=max_nms, conf_thres=conf_thres,
                                              class_mask=class_mask)
                return nms_from_topk(tb, ts, tc, iou_thres=iou_thres, agnostic=agnostic,
                                     max_det=max_det, backend=backend)
        boxes, scores, cls = self.decode_parts(raw, class_mask=class_mask,
                                               ref_order=ref_order)
        return nms_parts(boxes, scores, cls, conf_thres=conf_thres,
                         iou_thres=iou_thres, agnostic=agnostic,
                         max_det=max_det, max_nms=min(max_nms, boxes.shape[1]),
                         backend=backend)


def load_model(cfg, ch: int = 3, nc: Optional[int] = None, anchors=None,
               device=None) -> DetectionModel:
    return DetectionModel(cfg, ch=ch, nc=nc, anchors=anchors, device=device)
