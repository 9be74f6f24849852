"""YOLOv4-tiny ONNX weight importer (and fixture exporter): the port's
own copy of grid_vision_tpu/models/onnx_import.py (numpy and struct only).

The reference consumes pre-exported YOLOv4 ONNX blobs
(src/object_detection.cpp:41-58 loads ``detection_weights_file`` from
config/grid_vision_cfg.yaml:5). ``weights.load_all`` routes ``*.onnx``
detection weights through :func:`import_yolov4_tiny`, which maps the
export's Conv/BatchNormalization tensors onto a flax-keyed YoloV4Tiny tree
of numpy arrays (``weights.flax_tree`` of the port's module gives the
template; ``weights.load_module`` loads the result), as the JAX package
maps them onto its Flax tree.

No ``onnx`` package is needed: the file is parsed with a minimal protobuf
wire-format reader (ModelProto -> GraphProto -> NodeProto/TensorProto),
decoding only the fields the importer needs and skipping the rest by wire
type. :func:`export_yolov4_tiny` writes the inverse, for round-trip test
fixtures, byte for byte as the JAX package's writer does.

Mapping convention (the darknet/pytorch-YOLOv4 export lineage the
reference's tensor names come from): the 21 Conv nodes are ordered by a
dependency-driven topological sort (serialized order only breaks ties),
each ConvBN's convolution paired with the BatchNormalization node that
consumes its output; the two detection-head convs carry a bias and no BN.
When every conv weight initializer carries a darknet layer index in its
name (``models.{i}.conv{i}.weight``), that index orders them instead.
Conv weights are OIHW; flax kernels are HWIO. Every assignment is
shape-checked; the first mismatch raises naming the offending node, its
weight tensor and both shapes.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# --------------------------------------------------------------------------
# protobuf wire-format primitives
# --------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    LEN fields yield bytes; VARINT yields int; 32/64-bit yield raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 0x7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _WIRE_64BIT:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_32BIT:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _tag(field: int, wire: int) -> bytes:
    return _write_varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _WIRE_LEN) + _write_varint(len(payload)) + payload


# --------------------------------------------------------------------------
# ONNX message decoding (field numbers per onnx.proto3)
# --------------------------------------------------------------------------

_TENSOR_FLOAT = 1
_TENSOR_INT64 = 7


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    """TensorProto: dims=1, data_type=2, float_data=4, name=8, raw_data=9,
    int64_data=7."""
    dims: List[int] = []
    dtype = _TENSOR_FLOAT
    name = ""
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == _WIRE_VARINT:
                dims.append(val)
            else:  # packed
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    dims.append(d)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wire == _WIRE_32BIT:
                floats.append(struct.unpack("<f", val)[0])
            else:  # packed
                floats.extend(np.frombuffer(val, "<f4").tolist())
        elif field == 7:
            if wire == _WIRE_VARINT:
                ints.append(val)
            else:
                p = 0
                while p < len(val):
                    d, p = _read_varint(val, p)
                    ints.append(d)
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    if dtype == _TENSOR_FLOAT:
        arr = (np.frombuffer(raw, "<f4") if raw
               else np.asarray(floats, np.float32))
    elif dtype == _TENSOR_INT64:
        arr = (np.frombuffer(raw, "<i8") if raw
               else np.asarray(ints, np.int64))
    else:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype}")
    return name, arr.reshape(dims if dims else (-1,)).copy()


def _parse_node(buf: bytes) -> Dict[str, Any]:
    """NodeProto: input=1, output=2, name=3, op_type=4."""
    node = {"inputs": [], "outputs": [], "name": "", "op_type": ""}
    for field, _wire, val in _iter_fields(buf):
        if field == 1:
            node["inputs"].append(val.decode())
        elif field == 2:
            node["outputs"].append(val.decode())
        elif field == 3:
            node["name"] = val.decode()
        elif field == 4:
            node["op_type"] = val.decode()
    return node


def load_graph(path: str):
    """Parse an ONNX file -> (nodes, initializers).

    nodes: list of {op_type, name, inputs, outputs} in graph order;
    initializers: {name: np.ndarray}.
    """
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, _wire, val in _iter_fields(model):
        if field == 7:  # ModelProto.graph
            graph = val
    if graph is None:
        raise ValueError(f"{path}: no GraphProto (not an ONNX model?)")
    nodes: List[Dict[str, Any]] = []
    inits: Dict[str, np.ndarray] = {}
    for field, _wire, val in _iter_fields(graph):
        if field == 1:    # GraphProto.node
            nodes.append(_parse_node(val))
        elif field == 5:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            inits[name] = arr
    return nodes, inits


# --------------------------------------------------------------------------
# YOLOv4-tiny mapping
# --------------------------------------------------------------------------

# Flax module order of YoloV4Tiny's convolutions (== darknet layer order
# == the execution order a traced export serializes). Entries are
# (top-level module, has_batchnorm); CSP blocks expand to their three
# inner ConvBNs.
_CONV_ORDER: Tuple[Tuple[str, bool], ...] = (
    ("ConvBN_0", True), ("ConvBN_1", True), ("ConvBN_2", True),
    ("CSPBlock_0/ConvBN_0", True), ("CSPBlock_0/ConvBN_1", True),
    ("CSPBlock_0/ConvBN_2", True),
    ("ConvBN_3", True),
    ("CSPBlock_1/ConvBN_0", True), ("CSPBlock_1/ConvBN_1", True),
    ("CSPBlock_1/ConvBN_2", True),
    ("ConvBN_4", True),
    ("CSPBlock_2/ConvBN_0", True), ("CSPBlock_2/ConvBN_1", True),
    ("CSPBlock_2/ConvBN_2", True),
    ("ConvBN_5", True), ("ConvBN_6", True), ("ConvBN_7", True),
    ("head_13", False),
    ("ConvBN_8", True), ("ConvBN_9", True),
    ("head_26", False),
)


def _topo_sort(nodes: List[Dict[str, Any]],
               inits: Dict[str, np.ndarray]) -> List[Dict[str, Any]]:
    """Dependency-driven execution order (Kahn), serialized order as the
    tie-break. Real torch exports serialize in execution order already —
    then this is the identity — but nothing in the ONNX spec requires
    it, and initializer-only inputs (weights, Resize scales, Shape
    constants) are available from the start."""
    produced = {o for n in nodes for o in n["outputs"]}
    available = set(inits)
    # graph inputs: referenced tensors nobody produces (the image input)
    for n in nodes:
        for i in n["inputs"]:
            if i and i not in produced:
                available.add(i)
    pending = list(nodes)
    ordered: List[Dict[str, Any]] = []
    while pending:
        progressed = False
        rest = []
        for n in pending:
            if all((not i) or i in available for i in n["inputs"]):
                ordered.append(n)
                available.update(n["outputs"])
                progressed = True
            else:
                rest.append(n)
        if not progressed:
            missing = [i for i in rest[0]["inputs"]
                       if i and i not in available]
            raise ValueError(
                f"graph is not a DAG / has dangling inputs: node "
                f"{rest[0]['name'] or rest[0]['op_type']!r} waits on "
                f"{missing}")
        pending = rest
    return ordered


_NAME_INDEX_RE = None  # compiled lazily


def _darknet_layer_index(weight_name: str):
    """Darknet layer index from a pytorch-YOLOv4 initializer name
    (``models.{i}.conv{i}.weight`` / ``module_list.{i}.Conv2d.weight``
    style), or None if the name carries no index."""
    global _NAME_INDEX_RE
    import re
    if _NAME_INDEX_RE is None:
        _NAME_INDEX_RE = re.compile(
            r"(?:^|\.)(?:models|module_list|layers)\.(\d+)\.")
    m = _NAME_INDEX_RE.search(weight_name)
    return int(m.group(1)) if m else None


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A deep copy as nested dicts of numpy arrays."""
    return {k: _copy_tree(v) if isinstance(v, dict) else np.array(v)
            for k, v in tree.items()}


def _tree_get(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _tree_set(tree: Dict[str, Any], path: str, leaf: str,
              value: np.ndarray) -> None:
    node = _tree_get(tree, path)
    old = node[leaf]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"{path}/{leaf}: checkpoint shape {tuple(value.shape)} != "
            f"model shape {tuple(old.shape)}")
    node[leaf] = value.astype(np.asarray(old).dtype)


def import_yolov4_tiny(path: str, variables: Dict[str, Any]
                       ) -> Dict[str, Any]:
    """Load an ONNX YOLOv4-tiny export into a flax-keyed variables tree.

    variables: the target {'params', 'batch_stats'} tree of arrays (defines
    the expected shapes: weights.flax_tree of a YoloV4Tiny). Returns a new
    tree of numpy arrays with every Conv kernel/bias and
    BatchNormalization scale/bias/mean/var replaced by the checkpoint
    tensors.
    """
    nodes, inits = load_graph(path)
    nodes = _topo_sort(nodes, inits)
    convs = [n for n in nodes if n["op_type"] == "Conv"]
    bn_by_input = {n["inputs"][0]: n for n in nodes
                   if n["op_type"] == "BatchNormalization"}
    if len(convs) != len(_CONV_ORDER):
        extra = [n["name"] or n["inputs"][1] for n in convs]
        raise ValueError(
            f"{path}: expected {len(_CONV_ORDER)} Conv nodes "
            f"(yolov4-tiny), found {len(convs)}: {extra}")

    # Name-based ordering when the export carries darknet layer indices
    # in its initializer names (pytorch-YOLOv4 lineage); topological
    # order otherwise. Both are verified shape-by-shape below.
    indices = [_darknet_layer_index(n["inputs"][1]) for n in convs]
    if all(i is not None for i in indices) and len(set(indices)) == len(
            indices):
        convs = [n for _, n in sorted(zip(indices, convs),
                                      key=lambda t: t[0])]

    variables = _copy_tree(variables)
    params = variables["params"]
    stats = variables["batch_stats"]

    for conv_node, (path_, has_bn) in zip(convs, _CONV_ORDER):
        wname = conv_node["inputs"][1]
        if wname not in inits:
            raise ValueError(
                f"{path}: Conv {conv_node['name'] or wname!r} weight "
                f"{wname!r} is not an initializer (dynamic weights are "
                "not supported)")
        w = inits[wname]                           # OIHW
        if w.ndim != 4:
            raise ValueError(
                f"{path}: Conv weight {wname!r} has rank {w.ndim}, "
                "expected 4 (OIHW)")
        kernel = np.transpose(w, (2, 3, 1, 0))     # -> HWIO
        if has_bn:
            conv_path = path_ + "/Conv_0"
            bn_path = path_ + "/BatchNorm_0"
        else:
            conv_path = path_
            bn_path = None
        try:
            _tree_set(params, conv_path, "kernel", kernel)
            if len(conv_node["inputs"]) > 2 and conv_node["inputs"][2]:
                _tree_set(params, conv_path, "bias",
                          inits[conv_node["inputs"][2]])
        except ValueError as e:
            raise ValueError(
                f"{path}: first unmatched node: Conv "
                f"{conv_node['name'] or wname!r} (weight {wname!r}, "
                f"OIHW {tuple(w.shape)}) does not fit {conv_path}: {e}"
            ) from e
        if has_bn:
            bn = bn_by_input.get(conv_node["outputs"][0])
            if bn is None:
                raise ValueError(
                    f"{path}: first unmatched node: Conv "
                    f"{conv_node['name'] or conv_path!r} output feeds no "
                    "BatchNormalization node (expected Conv->BN->"
                    "LeakyRelu; head convs with bias must come last in "
                    "darknet order)")
            missing = [i for i in bn["inputs"][1:5] if i not in inits]
            if missing:
                raise ValueError(
                    f"{path}: BatchNormalization "
                    f"{bn['name'] or bn['inputs'][0]!r} parameters "
                    f"{missing} are not initializers")
            scale, bias, mean, var = (inits[i] for i in bn["inputs"][1:5])
            _tree_set(params, bn_path, "scale", scale)
            _tree_set(params, bn_path, "bias", bias)
            _tree_set(stats, bn_path, "mean", mean)
            _tree_set(stats, bn_path, "var", var)
    return variables


# --------------------------------------------------------------------------
# fixture exporter (round-trip testing; the real blob is unrecoverable)
# --------------------------------------------------------------------------

def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    out = b""
    for d in arr.shape:
        out += _tag(1, _WIRE_VARINT) + _write_varint(d)
    if arr.dtype == np.int64:
        out += _tag(2, _WIRE_VARINT) + _write_varint(_TENSOR_INT64)
        raw = arr.astype("<i8").tobytes()
    else:
        out += _tag(2, _WIRE_VARINT) + _write_varint(_TENSOR_FLOAT)
        raw = arr.astype("<f4").tobytes()
    out += _len_field(8, name.encode())
    out += _len_field(9, raw)
    return out


def _node_bytes(op_type: str, name: str, inputs: List[str],
                outputs: List[str]) -> bytes:
    out = b""
    for i in inputs:
        out += _len_field(1, i.encode())
    for o in outputs:
        out += _len_field(2, o.encode())
    out += _len_field(3, name.encode())
    out += _len_field(4, op_type.encode())
    return out


def export_yolov4_tiny(variables: Dict[str, Any], path: str,
                       style: str = "flax") -> None:
    """Write a flax-keyed YoloV4Tiny variables tree as a minimal ONNX file in
    the darknet-export convention import_yolov4_tiny consumes (Conv
    [+Bias] -> BatchNormalization -> LeakyRelu chains, interleaved
    non-parameter ops included so the importer is exercised against a
    realistically-shaped graph).

    style="flax": tensors named w{i}/bn{i}_{j}, nodes and initializers
    serialized in execution order (the round-2 fixture shape).

    style="pytorch": mimics the pytorch-YOLOv4 export lineage the
    reference's blobs come from (yolov4_1_3_416_416_static.onnx,
    src/object_detection.cpp:41-58): darknet-indexed initializer names
    (models.{i}.conv{i}.weight / models.{i}.bn{i}.running_mean),
    initializers serialized in SHUFFLED (non-execution) order, the neck
    branches serialized 26-grid-first (topologically valid but
    misleading serialized conv order — only name-based mapping recovers
    it), a Resize node with a scales initializer, Concat routes, and a
    decode subgraph (Sigmoid/Slice/Exp/Mul/Concat producing the
    boxes/confs outputs of object_detection.cpp:79-80).
    """
    if style not in ("flax", "pytorch"):
        raise ValueError(f"unknown fixture style {style!r}")
    variables = _copy_tree(variables)
    params = variables["params"]
    stats = variables["batch_stats"]

    node_list: List[Tuple[str, str, List[str], List[str]]] = []
    init_list: List[Tuple[str, np.ndarray]] = []

    def emit_conv(i: int, path_: str, has_bn: bool, src: str) -> str:
        """Append Conv[->BN->LeakyRelu] for _CONV_ORDER[i]; returns the
        output tensor name. i doubles as the darknet layer index."""
        conv_path = path_ + "/Conv_0" if has_bn else path_
        kernel = _tree_get(params, conv_path)["kernel"]
        w = np.transpose(kernel, (3, 2, 0, 1))     # HWIO -> OIHW
        if style == "pytorch":
            wname = f"models.{i}.conv{i}.weight"
        else:
            wname = f"w{i}"
        init_list.append((wname, w))
        conv_inputs = [src, wname]
        if "bias" in _tree_get(params, conv_path):
            bname = (f"models.{i}.conv{i}.bias" if style == "pytorch"
                     else f"b{i}")
            init_list.append((bname, _tree_get(params, conv_path)["bias"]))
            conv_inputs.append(bname)
        conv_out = f"conv{i}"
        node_list.append(("Conv", f"Conv_{i}", conv_inputs, [conv_out]))
        out = conv_out
        if has_bn:
            bn_path = path_ + "/BatchNorm_0"
            bn_in = [conv_out]
            leaf_names = (("scale", params, "weight"),
                          ("bias", params, "bias"),
                          ("mean", stats, "running_mean"),
                          ("var", stats, "running_var"))
            for j, (leaf, tree, torch_leaf) in enumerate(leaf_names):
                tname = (f"models.{i}.bn{i}.{torch_leaf}"
                         if style == "pytorch" else f"bn{i}_{j}")
                init_list.append((tname, _tree_get(tree, bn_path)[leaf]))
                bn_in.append(tname)
            bn_out = f"bn{i}"
            node_list.append(("BatchNormalization", f"BN_{i}", bn_in,
                              [bn_out]))
            relu_out = f"lrelu{i}"
            node_list.append(("LeakyRelu", f"LeakyRelu_{i}", [bn_out],
                              [relu_out]))
            out = relu_out
        # sprinkle the structural ops a real export interleaves
        if path_ in ("CSPBlock_0/ConvBN_2", "CSPBlock_1/ConvBN_2",
                     "CSPBlock_2/ConvBN_2"):
            cat = f"cat{i}"
            node_list.append(("Concat", f"Concat_{i}", [out, out], [cat]))
            mp = f"mp{i}"
            node_list.append(("MaxPool", f"MaxPool_{i}", [cat], [mp]))
            out = mp
        if path_ == "ConvBN_8":
            up = f"up{i}"
            if style == "pytorch":
                # real Resize: (X, roi, scales) with scales an initializer
                init_list.append(
                    ("resize_scales",
                     np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)))
                node_list.append(("Resize", f"Resize_{i}",
                                  [out, "", "resize_scales"], [up]))
            else:
                node_list.append(("Resize", f"Resize_{i}", [out], [up]))
            out = up
        return out

    order = list(enumerate(_CONV_ORDER))
    if style == "pytorch":
        # serialize the 26-grid neck branch (ConvBN_8/9, head_26) BEFORE
        # the 13-grid one (ConvBN_7, head_13): topologically valid, but
        # the serialized conv order no longer matches darknet order.
        backbone = order[:16]            # up to and incl. ConvBN_6
        b13 = [order[16], order[17]]     # ConvBN_7, head_13
        b26 = order[18:]                 # ConvBN_8, ConvBN_9, head_26
        order = backbone + b26 + b13
    prev = "input"
    fork = None
    for i, (path_, has_bn) in order:
        if path_ in ("ConvBN_7", "ConvBN_8"):
            if fork is None:
                fork = prev              # both neck branches eat ConvBN_6
            src = fork
        else:
            src = prev
        prev = emit_conv(i, path_, has_bn, src)

    if style == "pytorch":
        # decode subgraph: the exporter's get_region_boxes tail
        # (sigmoid/exp/slice/mul soup ending in boxes/confs).
        head13, head26 = "conv17", "conv20"
        node_list += [
            ("Slice", "dec_slice_xy", [head13], ["d_xy"]),
            ("Sigmoid", "dec_sig_xy", ["d_xy"], ["d_sxy"]),
            ("Slice", "dec_slice_wh", [head13], ["d_wh"]),
            ("Exp", "dec_exp_wh", ["d_wh"], ["d_ewh"]),
            ("Mul", "dec_mul_wh", ["d_ewh", "anchor_grid"], ["d_mwh"]),
            ("Sigmoid", "dec_sig_conf", [head26], ["d_conf"]),
            ("Concat", "dec_cat_boxes", ["d_sxy", "d_mwh"], ["boxes"]),
            ("Concat", "dec_cat_confs", ["d_conf", "d_conf"], ["confs"]),
        ]
        init_list.append(
            ("anchor_grid", np.ones((1, 3, 13, 13, 2), np.float32)))
        # initializers in shuffled (non-execution) order — real torch
        # exports do not promise execution-ordered initializers
        rng = np.random.default_rng(41)
        init_list = [init_list[k]
                     for k in rng.permutation(len(init_list))]

    nodes = b""
    for op, name, ins, outs in node_list:
        nodes += _len_field(1, _node_bytes(op, name, ins, outs))
    inits = b""
    for name, arr in init_list:
        inits += _len_field(5, _tensor_bytes(name, arr))

    graph = nodes + inits + _len_field(2, b"yolov4_tiny_fixture")
    model = (_tag(1, _WIRE_VARINT) + _write_varint(8)     # ir_version
             + _len_field(7, graph))
    with open(path, "wb") as f:
        f.write(model)
