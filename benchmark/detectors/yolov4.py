"""The plain reference of YOLOv4 (darknet cfg/yolov4.cfg with classes=10;
Bochkovskiy et al., arXiv:2004.10934), the engine's detector_arch="yolov4",
in plain torch and numpy. It imports nothing of the program.

The weights: the configuration's detector file is a weights recipe
(weights/yolov4_seeded.npz), which reference.load_net reads as
{"recipe/seed": ..., ...} (nets.det); expand() turns it into every weight,
bit for bit as the program's models/weights.expand_yolov4_recipe does:

  one numpy.random.default_rng(seed); for each of the 110 convs in cfg
  order (ConvBN_0 .. ConvBN_92, head_52, ConvBN_93 .. ConvBN_99, head_26,
  ConvBN_100 .. ConvBN_106, head_13), z = standard_normal((c_out, c_in, k,
  k), float32);
  - a conv + BatchNorm: kernel z * (gain / sqrt(c_in k k)) in float32,
    gain mish_gain or leaky_gain by its activation; then u =
    standard_normal((4, c_out), float32): scale 1 + bn_spread u[0] (times
    res_scale where the conv ends a residual branch), bias bn_spread u[1],
    mean bn_spread u[2], var exp(bn_spread u[3]);
  - a head: kernel z times box_gain / sqrt(c_in) on each anchor's four
    box channels and logit_gain / sqrt(c_in) on its objectness and class
    channels; bias 0 on the box channels, obj_bias[head] on the
    objectness, cls_bias on the classes (no draw).

The forward, in IEEE f32 (reference.ieee()): each conv with its
BatchNorm unfolded (F.batch_norm), Mish as x * tanh(softplus(x)) on the
backbone's 72 convs, leaky 0.1 on the neck's 35; the conv operands rounded
as nets.mode says (nets.conv). Routes concatenate on channels, shortcuts
add, SPP max-pools pad with -inf, upsampling is nearest. Each head
decodes with its anchors and scale_x_y (1.2, 1.1, 1.05), stride 8 first.

Where this departs from a literal reading of the cfg:
  - the padding: darknet pads (size - 1) / 2 on every side (pad=1), which
    is taken as written; a 3x3/s2 conv on an even side gives half of it;
  - the frames are resized by reference.py's antialiased linear resize
    (the engine's detector front end), not darknet's letterbox;
  - the YOLO layers' new_coords=0 decode with the node's normalized
    boxes: center (sigmoid(t) * s - (s - 1) / 2 + cell) / grid, size
    exp(t) * anchor / input; confidence sigmoid(obj) * sigmoid(cls);
  - darknet's own BatchNorm epsilon is 1e-6 (0.00001 in its cuDNN path);
    this uses 1e-5, the program's (flax's) value.

detector_ops(size) counts the model's operations a frame (2 a
multiply-add, the 110 convs); detector_work(size) gives each layer's
operations and bytes for the roofline. The controls (control()): "leaky",
the same net with leaky 0.1 in place of Mish (a program that leaves Mish
out); any other mode (the configuration's "fp8") is this detector with
nets in that mode's rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import reference as ref

CLASSES = 10
ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
           (142, 110), (192, 243), (459, 401))
# per YOLO layer, in cfg order: (anchor mask, scale_x_y)
YOLO = (((0, 1, 2), 1.2), ((3, 4, 5), 1.1), ((6, 7, 8), 1.05))
HEAD_NAMES = ("head_52", "head_26", "head_13")
# frames a forward holds at once (the judge and the control give it 32)
BLOCK = 32


def cfg_lines(classes: int = CLASSES) -> list:
    """yolov4.cfg's layers as darknet writes them: "conv filters size
    stride act", "route a b ..." (negative: relative), "shortcut -3",
    "maxpool size", "upsample", "yolo h"."""
    out = ["conv 32 3 1 mish"]

    def csp(c, part, inner, n):
        out.extend([f"conv {c} 3 2 mish", f"conv {part} 1 1 mish",
                    "route -2", f"conv {part} 1 1 mish"])
        for _ in range(n):
            out.extend([f"conv {inner} 1 1 mish", f"conv {part} 3 1 mish",
                        "shortcut -3"])
        out.extend([f"conv {part} 1 1 mish", f"route -1 -{3 * n + 4}",
                    f"conv {c} 1 1 mish"])

    csp(64, 64, 32, 1)
    csp(128, 64, 64, 2)
    csp(256, 128, 128, 8)
    csp(512, 256, 256, 8)
    csp(1024, 512, 512, 4)
    leaky = lambda *fs: out.extend(f"conv {f} {k} 1 leaky" for f, k in fs)
    leaky((512, 1), (1024, 3), (512, 1))
    out.extend(["maxpool 5", "route -2", "maxpool 9", "route -4",
                "maxpool 13", "route -1 -3 -5 -6"])
    leaky((512, 1), (1024, 3), (512, 1), (256, 1))
    out.extend(["upsample", "route 85"])
    leaky((256, 1))
    out.append("route -1 -3")
    leaky((256, 1), (512, 3), (256, 1), (512, 3), (256, 1), (128, 1))
    out.extend(["upsample", "route 54"])
    leaky((128, 1))
    out.append("route -1 -3")
    leaky((128, 1), (256, 3), (128, 1), (256, 3), (128, 1), (256, 3))
    n_out = 3 * (5 + classes)
    out.extend([f"head {n_out}", "yolo 0", "route -4", "conv 256 3 2 leaky",
                "route -1 -16"])
    leaky((256, 1), (512, 3), (256, 1), (512, 3), (256, 1), (512, 3))
    out.extend([f"head {n_out}", "yolo 1", "route -4", "conv 512 3 2 leaky",
                "route -1 -37"])
    leaky((512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3))
    out.extend([f"head {n_out}", "yolo 2"])
    return out


@functools.lru_cache(maxsize=None)
def layers(classes: int = CLASSES) -> tuple:
    """cfg_lines parsed: (kind, args, sources, channels out, name), the
    sources absolute; the convs named ConvBN_<n> in order, the heads by
    HEAD_NAMES."""
    out, chans, n_conv, n_head = [], [], 0, 0
    for i, line in enumerate(cfg_lines(classes)):
        kind, *args = line.split()
        src, name = (), ""
        if kind == "conv":
            name, n_conv = f"ConvBN_{n_conv}", n_conv + 1
            c = int(args[0])
        elif kind == "head":
            name, n_head = HEAD_NAMES[n_head], n_head + 1
            c = int(args[0])
        elif kind == "route":
            src = tuple(int(a) if int(a) >= 0 else i + int(a) for a in args)
            c = sum(chans[s] for s in src)
        elif kind == "shortcut":
            src = (i + int(args[0]),)
            c = chans[-1]
        else:
            c = chans[-1] if chans else 3
        out.append((kind, tuple(args), src, c, name))
        chans.append(c)
    return tuple(out)


def convs(classes: int = CLASSES) -> list:
    """The 110 convs in cfg order: (name, c_in, c_out, size, stride, act,
    ends a residual branch); act "linear" for a head."""
    ls = layers(classes)
    out = []
    for i, (kind, args, _, c, name) in enumerate(ls):
        c_in = ls[i - 1][3] if i else 3
        if kind == "conv":
            ends = i + 1 < len(ls) and ls[i + 1][0] == "shortcut"
            out.append((name, c_in, c, int(args[1]), int(args[2]), args[3],
                        ends))
        elif kind == "head":
            out.append((name, c_in, c, 1, 1, "linear", False))
    return out


# ---------------------------------------------------------------- weights

def expand(recipe: dict, device, classes: int = CLASSES) -> dict:
    """A weights recipe ({name: value}, load_net's "recipe/..." keys with
    the prefix taken off) -> {"<conv>/Conv_0/kernel": OIHW, BatchNorm's
    scale / bias / mean / var, "<head>/kernel", "<head>/bias"} as f32
    tensors on `device`, in the module docstring's order."""
    r = {k: np.asarray(torch.as_tensor(v).cpu().numpy(), np.float32)
         for k, v in recipe.items()}
    gen = np.random.default_rng(int(r["seed"]))
    w = {}
    h = 0
    for name, c_in, c_out, k, _, act, ends in convs(classes):
        z = gen.standard_normal((c_out, c_in, k, k), dtype=np.float32)
        if act == "linear":
            root = np.sqrt(np.float32(c_in), dtype=np.float32)
            row = np.arange(c_out) % (5 + classes)
            gain = np.where(row < 4, r["box_gain"] / root,
                            r["logit_gain"] / root).astype(np.float32)
            bias = np.where(row == 4, r["obj_bias"][h],
                            np.where(row >= 5, r["cls_bias"][
                                np.maximum(row - 5, 0)], 0.0))
            w[f"{name}/kernel"] = z * gain[:, None, None, None]
            w[f"{name}/bias"] = bias.astype(np.float32)
            h += 1
            continue
        gain = r["mish_gain"] if act == "mish" else r["leaky_gain"]
        w[f"{name}/Conv_0/kernel"] = z * (gain / np.sqrt(
            np.float32(c_in * k * k), dtype=np.float32))
        u = gen.standard_normal((4, c_out), dtype=np.float32)
        s = r["bn_spread"]
        scale = np.float32(1.0) + s * u[0]
        w[f"{name}/BatchNorm_0/scale"] = scale * r["res_scale"] if ends \
            else scale
        w[f"{name}/BatchNorm_0/bias"] = s * u[1]
        w[f"{name}/BatchNorm_0/mean"] = s * u[2]
        w[f"{name}/BatchNorm_0/var"] = np.exp(s * u[3])
    return {k: torch.as_tensor(v, device=device) for k, v in w.items()}


def weights(nets) -> dict:
    """expand(nets.det's recipe), once for each nets."""
    if "yolov4" not in nets.__dict__:
        first = next(iter(nets.det.values()))
        nets.yolov4 = expand({k[len("recipe/"):]: v
                              for k, v in nets.det.items()
                              if k.startswith("recipe/")}, first.device)
    return nets.yolov4


# ---------------------------------------------------------------- forward

def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _conv_bn(nets, p, name, x, stride, act):
    w = p[f"{name}/Conv_0/kernel"]
    pad = w.shape[-1] // 2
    y = nets.conv(F.pad(x, (pad, pad, pad, pad)), w, stride)
    y = F.batch_norm(y, p[f"{name}/BatchNorm_0/mean"],
                     p[f"{name}/BatchNorm_0/var"],
                     p[f"{name}/BatchNorm_0/scale"],
                     p[f"{name}/BatchNorm_0/bias"], False, 0.0, ref.BN_EPS)
    return mish(y) if act == "mish" else F.leaky_relu(y, 0.1)


def _decode(raw, anchors, scale, size):
    """One head (B, 3 (5 + C), H, W) -> boxes (B, 3HW, 4) normalized xyxy
    and confs (B, 3HW, C), anchor-major then row-major."""
    b, c, h, w = raw.shape
    raw = raw.reshape(b, 3, c // 3, h, w).permute(0, 1, 3, 4, 2)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=raw.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=raw.device), indexing="ij")
    bx = (torch.sigmoid(raw[..., 0]) * scale - 0.5 * (scale - 1.0) + gx) / w
    by = (torch.sigmoid(raw[..., 1]) * scale - 0.5 * (scale - 1.0) + gy) / h
    an = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    bw = torch.exp(raw[..., 2]) * (an[:, 0] / size)[None, :, None, None]
    bh = torch.exp(raw[..., 3]) * (an[:, 1] / size)[None, :, None, None]
    boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2],
                        -1)
    confs = torch.sigmoid(raw[..., 4:5]) * torch.sigmoid(raw[..., 5:])
    return boxes.reshape(b, -1, 4), confs.reshape(b, -1, confs.shape[-1])


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 255] -> (B, 3, size, size) in [0, 1]:
    reference.py's antialiased linear resize of the batch."""
    h, w = images.shape[1:3]
    wy = torch.as_tensor(ref.axis_resize_weights(h, size),
                         device=images.device)
    wx = torch.as_tensor(ref.axis_resize_weights(w, size),
                         device=images.device)
    x = torch.einsum("iy,byjc->bijc", wy,
                     torch.einsum("jx,byxc->byjc", wx, images.float()))
    return (x / 255.0).permute(0, 3, 1, 2).contiguous()


def heads_raw(nets, x: torch.Tensor, use_mish: bool = True,
              probe: dict | None = None) -> list:
    """The net on (B, 3, S, S) in [0, 1] -> the three heads' raw maps
    (B, 3 (5 + C), H, W), stride 8 first; use_mish=False: leaky 0.1 in
    every Mish's place (the "leaky" control). probe: {layer index: None}
    filled with those layers' output RMS."""
    p = weights(nets)
    outs, heads = [], []
    for i, (kind, args, src, _, name) in enumerate(layers()):
        if kind == "conv":
            act = args[3] if use_mish else "leaky"
            x = _conv_bn(nets, p, name, x, int(args[2]), act)
        elif kind == "head":
            heads.append(nets.conv(x, p[f"{name}/kernel"], 1,
                                   p[f"{name}/bias"]))
        elif kind == "route":
            x = torch.cat([outs[s] for s in src], 1)
        elif kind == "shortcut":
            x = x + outs[src[0]]
        elif kind == "maxpool":
            k = int(args[0])
            x = F.max_pool2d(x, k, 1, k // 2)
        elif kind == "upsample":
            x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
        outs.append(x)
        if probe is not None and i in probe:
            probe[i] = float(x.pow(2).mean().sqrt())
    return heads


@torch.no_grad()
def detect_dense(nets, images: torch.Tensor, size: int,
                 use_mish: bool = True):
    """(B, H, W, 3) frames in [0, 255] -> every anchor's (boxes (B, A, 4)
    normalized xyxy, confs (B, A, C)), the stride-8 head first, in blocks
    of BLOCK frames."""
    boxes, confs = [], []
    for i in range(0, images.shape[0], BLOCK):
        raws = heads_raw(nets, resize(images[i:i + BLOCK], size), use_mish)
        dec = [_decode(raw, [ANCHORS[a] for a in mask], scale, size)
               for raw, (mask, scale) in zip(raws, YOLO)]
        boxes.append(torch.cat([b for b, _ in dec], 1))
        confs.append(torch.cat([c for _, c in dec], 1))
    return torch.cat(boxes, 0), torch.cat(confs, 0)


def control(mode: str):
    """A Control mode -> (its detect_dense, reference.Nets's mode)."""
    if mode == "leaky":
        return functools.partial(detect_dense, use_mish=False), "f32"
    return detect_dense, mode


# ---------------------------------------------------------------- counts

def _sizes(size: int, classes: int = CLASSES):
    """Each layer's (input side, output side) at `size`."""
    out, side = [], size
    for kind, args, src, _, _ in layers(classes):
        n_in = side
        if kind == "conv" and int(args[2]) == 2:
            side = -(-side // 2)
        elif kind == "upsample":
            side *= 2
        elif kind == "route":
            side = out[src[0]][1]
        out.append((n_in, side))
    return out


def detector_work(size: int, elem: int = 2, classes: int = CLASSES) -> list:
    """Each layer's (name, operations, bytes) on one frame at `size`, the
    activations and weights `elem` bytes an element: a conv (its BatchNorm
    folded, its activation fused) reads its input and weights and writes
    its output once, 2 operations a multiply-add; a head writes f32; a
    shortcut reads two and writes one (one add an element); a max pool and
    an upsample read and write once (no operation counted); a route
    concatenates where its sources are written (nothing moves); the three
    decodes read the raw heads and write the boxes and confidences, f32."""
    out = []
    ls = layers(classes)
    sides = _sizes(size, classes)
    for i, ((kind, args, src, c, name), (n_in, n_out)) in enumerate(
            zip(ls, sides)):
        c_in = ls[i - 1][3] if i else 3
        if kind in ("conv", "head"):
            k = int(args[1]) if kind == "conv" else 1
            ops = 2 * n_out * n_out * c * k * k * c_in
            out_elem = elem if kind == "conv" else 4
            n_bytes = (n_in * n_in * c_in + c * c_in * k * k + c) * elem + \
                n_out * n_out * c * out_elem
            out.append((name, ops, n_bytes))
        elif kind == "shortcut":
            out.append((f"shortcut_{i}", n_out * n_out * c,
                        3 * n_out * n_out * c * elem))
        elif kind in ("maxpool", "upsample"):
            out.append((f"{kind}_{i}", 0,
                        (n_in * n_in + n_out * n_out) * c * elem))
        elif kind == "yolo":
            anchors = 3 * n_out * n_out
            out.append((f"decode_{i}", 0,
                        anchors * (5 + classes + 4 + classes) * 4))
    return out


def detector_ops(size: int, classes: int = CLASSES) -> int:
    """The model's operations a frame: the 110 convs' multiply-adds, 2
    each (59.596 G at 416 with 10 classes; 60.105 G with 80)."""
    return sum(ops for (name, ops, _) in detector_work(size, 2, classes)
               if name.startswith(("ConvBN_", "head_")))


def bound_s(size: int, frames: int, peak_ops: float, hbm: float,
            elem: int = 2) -> float:
    """The least time of `frames` forwards: per layer the larger of its
    operations at peak_ops and its bytes at hbm, summed."""
    return frames * math.fsum(max(ops / peak_ops, n / hbm)
                              for _, ops, n in detector_work(size, elem))
