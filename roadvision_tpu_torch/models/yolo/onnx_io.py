"""ONNX weight interchange — a copy of
``roadvision_tpu/models/yolo/onnx_io.py`` (numpy only).

A reader of the protobuf wire format (ModelProto → GraphProto →
TensorProto) that returns every named initializer as a numpy array — a
torch-style state dict that ``weights.load_params`` maps like a ``.pt``
— and a writer of weights-carrier models (initializers plus one
Identity node), with the name mapping from a parameter tree to the
ultralytics fused layout (``params_to_state_dict``, ``export_onnx``).
No ``onnx`` or ``onnxruntime`` package is needed.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np

# onnx.proto3 TensorProto.DataType → numpy dtype
_DTYPES = {
    1: np.dtype(np.float32), 2: np.dtype(np.uint8), 3: np.dtype(np.int8),
    4: np.dtype(np.uint16), 5: np.dtype(np.int16), 6: np.dtype(np.int32),
    7: np.dtype(np.int64), 9: np.dtype(np.bool_), 10: np.dtype(np.float16),
    11: np.dtype(np.float64), 12: np.dtype(np.uint32), 13: np.dtype(np.uint64),
}
_F32, _I64 = 1, 7


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    n = len(buf)
    while True:
        if i >= n:
            raise ValueError("truncated varint (corrupt ONNX file)")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow (corrupt ONNX file)")


def _fields(buf: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over one message's bytes.

    Length-delimited values come back as memoryview slices; varints as int;
    fixed32/fixed64 as raw 4/8-byte slices.
    """
    view = memoryview(buf)
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = view[i:i + ln]
            i += ln
        elif wt == 5:  # fixed32
            val = view[i:i + 4]
            i += 4
        elif wt == 1:  # fixed64
            val = view[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt} (group encoding?)")
        yield field, wt, val


def _packed_varints(data) -> list:
    buf = bytes(data)
    out, i = [], 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def _as_int64(v: int) -> int:
    """Interpret a varint as two's-complement int64 (proto int64 fields)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
def _parse_tensor(buf) -> Tuple[str, np.ndarray]:
    """Decode one TensorProto. Accepts packed AND unpacked repeated fields,
    raw_data or typed *_data arrays (both appear in the wild)."""
    dims: list = []
    data_type = _F32
    name = ""
    raw = None
    floats: list = []
    ints: list = []
    doubles: list = []
    for field, wt, val in _fields(bytes(buf)):
        if field == 1:  # dims: repeated int64
            if wt == 0:
                dims.append(_as_int64(val))
            else:
                dims.extend(_as_int64(v) for v in _packed_varints(val))
        elif field == 2 and wt == 0:  # data_type
            data_type = val
        elif field == 4:  # float_data
            if wt == 5:
                floats.append(struct.unpack("<f", bytes(val))[0])
            else:
                floats.append(np.frombuffer(bytes(val), "<f4"))
        elif field in (5, 7, 11):  # int32_data / int64_data / uint64_data
            # int32_data also carries int8/int16/uint8/uint16/bool/fp16/
            # bf16 per onnx.proto; negatives of any signed width are
            # encoded as 10-byte (2^64-|v|) varints → two's-complement
            # decode for the signed fields, raw for uint64_data.
            signed = field in (5, 7)
            if wt == 0:
                ints.append(_as_int64(val) if signed else val)
            else:
                vs = _packed_varints(val)
                if signed:
                    vs = [_as_int64(v) for v in vs]
                ints.extend(vs)
        elif field == 8 and wt == 2:  # name
            name = bytes(val).decode("utf-8")
        elif field == 9 and wt == 2:  # raw_data
            raw = bytes(val)
        elif field == 10:  # double_data
            if wt == 1:
                doubles.append(struct.unpack("<d", bytes(val))[0])
            else:
                doubles.append(np.frombuffer(bytes(val), "<f8"))
        # segment(3), string_data(6), external_data(13), etc.: skipped
    def _cat(parts, dt):
        return np.concatenate(
            [p if isinstance(p, np.ndarray) else np.array([p], dt)
             for p in parts]).astype(dt, copy=False)

    if data_type == 16 and raw is not None:  # bfloat16: no numpy dtype name
        u16 = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
        arr = u16.view(np.float32).astype(np.float32)
    elif raw is not None:
        dt = _DTYPES.get(data_type)
        if dt is None:
            raise ValueError(f"tensor '{name}': unsupported data_type "
                             f"{data_type}")
        arr = np.frombuffer(raw, dt.newbyteorder("<"))
    elif floats:
        arr = _cat(floats, np.dtype(np.float32))
    elif doubles:
        arr = _cat(doubles, np.dtype(np.float64))
    elif ints:
        # typed *_data for half floats stores BIT PATTERNS (onnx.proto:
        # "float16/bfloat16 values bit-cast to uint16"), not numerics
        if data_type == 10:  # float16
            arr = np.asarray(ints, np.uint16).view(np.float16)
        elif data_type == 16:  # bfloat16 → widen to float32
            u32 = np.asarray(ints, np.uint16).astype(np.uint32) << 16
            arr = u32.view(np.float32)
        else:
            dt = _DTYPES.get(data_type, np.dtype(np.int64))
            wide = np.uint64 if dt.kind == "u" else np.int64
            arr = np.asarray(ints, wide).astype(dt)
    else:
        arr = np.zeros(0, _DTYPES.get(data_type, np.dtype(np.float32)))
    shape = tuple(int(d) for d in dims)
    if shape and int(np.prod(shape)) != arr.size:
        raise ValueError(f"tensor '{name}': dims {shape} != {arr.size} elems")
    return name, arr.reshape(shape)


def _graph_initializers(buf, out: Dict[str, np.ndarray],
                        skipped: list) -> None:
    for field, wt, val in _fields(bytes(buf)):
        if field == 5 and wt == 2:  # initializer: repeated TensorProto
            try:
                name, arr = _parse_tensor(val)
            except ValueError as exc:
                # an unconvertible initializer (fp8/int4/string payloads)
                # need not block the load: the YOLO weight mapping may
                # never read it — note it and move on
                skipped.append(str(exc))
                continue
            if name:
                out[name] = arr


def load_onnx(path) -> Dict[str, np.ndarray]:
    """Read every named initializer of an ONNX model → {name: ndarray}.

    The result is a torch-style state dict (OIHW conv weights, fused-BN
    names for ultralytics exports) consumable by
    weights.state_dict_to_params / load_params. Initializers with
    payloads this parser cannot represent (fp8/int4/strings) are skipped
    with a console note; the load fails only if nothing is readable.
    """
    buf = Path(path).read_bytes()
    out: Dict[str, np.ndarray] = {}
    skipped: list = []
    for field, wt, val in _fields(buf):
        if field == 7 and wt == 2:  # ModelProto.graph
            _graph_initializers(val, out, skipped)
    if skipped:
        print(f"[roadvision] {path}: skipped {len(skipped)} unreadable "
              f"initializer(s): {skipped[0]}"
              + (" ..." if len(skipped) > 1 else ""))
    if not out:
        raise ValueError(f"{path}: no initializers found (not an ONNX "
                         f"model, or weights stored as external data)")
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _vi(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    dtype_code = None
    for code, dt in _DTYPES.items():
        if dt == arr.dtype:
            dtype_code = code
            break
    if dtype_code is None:
        raise ValueError(f"unsupported export dtype {arr.dtype} for {name}")
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    msg = _ld(1, dims) if arr.shape else b""
    msg += _vi(2, dtype_code)
    msg += _ld(8, name.encode("utf-8"))
    msg += _ld(9, arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes())
    return msg


def save_onnx(state_dict: Mapping[str, np.ndarray], path, *,
              doc: str = "roadvision_tpu weights carrier") -> None:
    """Write a valid-wire-format ONNX ModelProto holding ``state_dict`` as
    named initializers (plus a single Identity node so the graph is
    well-formed). Round-trips through :func:`load_onnx`."""
    inits = b"".join(_ld(5, _tensor_bytes(k, np.asarray(v)))
                     for k, v in state_dict.items())
    # NodeProto: input("w0") output("w0_out") op_type("Identity")
    first = next(iter(state_dict), None)
    node = b""
    if first is not None:
        node = _ld(1, _ld(1, first.encode()) + _ld(2, b"identity_out") +
                   _ld(4, b"Identity"))
    graph = node + _ld(2, b"roadvision_weights") + inits
    # OperatorSetIdProto: version=17 (field 2)
    opset = _vi(2, 17)
    model = (_vi(1, 8)  # ir_version 8
             + _ld(2, b"roadvision_tpu")  # producer_name
             + _ld(6, doc.encode("utf-8"))  # doc_string
             + _ld(7, graph)
             + _ld(8, opset))
    Path(path).write_bytes(model)


# ---------------------------------------------------------------------------
# params pytree → ultralytics-style fused state dict (export direction)
# ---------------------------------------------------------------------------
def _put_plain(sd: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = \
        np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO→OIHW
    sd[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)


def _put_conv(sd: Dict[str, np.ndarray], prefix: str, p: Mapping) -> None:
    _put_plain(sd, f"{prefix}.conv", p)


def params_to_state_dict(params: Mapping[str, Any],
                         arch: str = "v8") -> Dict[str, np.ndarray]:
    """Inverse of weights.state_dict_to_params (fused form: conv.weight +
    conv.bias, no BN keys — the post-``model.fuse()`` ultralytics layout)."""
    from . import weights as W
    sd: Dict[str, np.ndarray] = {}
    if arch == "11":
        return _params_to_state_dict_11(params)
    if arch == "v8":
        conv_layers, block_layers, head = W._CONV_LAYERS, W._C2F_LAYERS, "22"
    else:
        conv_layers, block_layers, head = (W._V5_CONV_LAYERS,
                                           W._V5_C3_LAYERS, "24")
    for i in conv_layers:
        _put_conv(sd, f"model.{i}", params[i])
    for i in block_layers:
        blk = params[i]
        for cv in ("cv1", "cv2", "cv3"):
            if cv in blk:
                _put_conv(sd, f"model.{i}.{cv}", blk[cv])
        for j, m in enumerate(blk["m"]):
            _put_conv(sd, f"model.{i}.m.{j}.cv1", m["cv1"])
            _put_conv(sd, f"model.{i}.m.{j}.cv2", m["cv2"])
    _put_conv(sd, "model.9.cv1", params["9"]["cv1"])
    _put_conv(sd, "model.9.cv2", params["9"]["cv2"])
    if arch == "v8":
        det = params[head]
        branches = ("cv2", "cv3") + (("cv4",) if "cv4" in det else ())
        for branch in branches:
            for lvl in range(3):
                stages = det[branch][lvl]
                _put_conv(sd, f"model.22.{branch}.{lvl}.0", stages[0])
                _put_conv(sd, f"model.22.{branch}.{lvl}.1", stages[1])
                _put_plain(sd, f"model.22.{branch}.{lvl}.2", stages[2])
        if "proto" in det:  # Segment head (models/yolo/yolov8_seg.py)
            pr = det["proto"]
            _put_conv(sd, "model.22.proto.cv1", pr["cv1"])
            sd["model.22.proto.upsample.weight"] = np.asarray(
                pr["up_w"], np.float32).transpose(2, 3, 0, 1)  # HWIO→IOHW
            sd["model.22.proto.upsample.bias"] = np.asarray(
                pr["up_b"], np.float32)
            _put_conv(sd, "model.22.proto.cv2", pr["cv2"])
            _put_conv(sd, "model.22.proto.cv3", pr["cv3"])
    else:
        for lvl, m in enumerate(params[head]["m"]):
            _put_plain(sd, f"model.24.m.{lvl}", m)
    return sd


def _params_to_state_dict_11(params: Mapping[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """YOLO11 pytree → fused ultralytics key layout (detect layer 23,
    C3k2 blocks with optional nested C3k, C2PSA at 10)."""
    from . import weights as W
    sd: Dict[str, np.ndarray] = {}
    for i in W._C11_CONV_LAYERS:
        _put_conv(sd, f"model.{i}", params[i])
    for i in W._C11_C3K2_LAYERS:
        blk = params[i]
        _put_conv(sd, f"model.{i}.cv1", blk["cv1"])
        _put_conv(sd, f"model.{i}.cv2", blk["cv2"])
        for j, m in enumerate(blk["m"]):
            _put_conv(sd, f"model.{i}.m.{j}.cv1", m["cv1"])
            _put_conv(sd, f"model.{i}.m.{j}.cv2", m["cv2"])
            if "cv3" in m:
                _put_conv(sd, f"model.{i}.m.{j}.cv3", m["cv3"])
                for k, mm in enumerate(m["m"]):
                    _put_conv(sd, f"model.{i}.m.{j}.m.{k}.cv1", mm["cv1"])
                    _put_conv(sd, f"model.{i}.m.{j}.m.{k}.cv2", mm["cv2"])
    _put_conv(sd, "model.9.cv1", params["9"]["cv1"])
    _put_conv(sd, "model.9.cv2", params["9"]["cv2"])
    _put_conv(sd, "model.10.cv1", params["10"]["cv1"])
    _put_conv(sd, "model.10.cv2", params["10"]["cv2"])
    for j, m in enumerate(params["10"]["m"]):
        _put_conv(sd, f"model.10.m.{j}.attn.qkv", m["attn"]["qkv"])
        _put_conv(sd, f"model.10.m.{j}.attn.proj", m["attn"]["proj"])
        _put_conv(sd, f"model.10.m.{j}.attn.pe", m["attn"]["pe"])
        _put_conv(sd, f"model.10.m.{j}.ffn.0", m["ffn"][0])
        _put_conv(sd, f"model.10.m.{j}.ffn.1", m["ffn"][1])
    det = params["23"]
    for lvl in range(3):
        _put_conv(sd, f"model.23.cv2.{lvl}.0", det["cv2"][lvl][0])
        _put_conv(sd, f"model.23.cv2.{lvl}.1", det["cv2"][lvl][1])
        _put_plain(sd, f"model.23.cv2.{lvl}.2", det["cv2"][lvl][2])
        cls = det["cv3"][lvl]
        _put_conv(sd, f"model.23.cv3.{lvl}.0.0", cls[0]["dw"])
        _put_conv(sd, f"model.23.cv3.{lvl}.0.1", cls[0]["pw"])
        _put_conv(sd, f"model.23.cv3.{lvl}.1.0", cls[1]["dw"])
        _put_conv(sd, f"model.23.cv3.{lvl}.1.1", cls[1]["pw"])
        _put_plain(sd, f"model.23.cv3.{lvl}.2", cls[2])
        if "cv4" in det:   # task side branch (seg coeffs / kpts / angle)
            stages = det["cv4"][lvl]
            _put_conv(sd, f"model.23.cv4.{lvl}.0", stages[0])
            _put_conv(sd, f"model.23.cv4.{lvl}.1", stages[1])
            _put_plain(sd, f"model.23.cv4.{lvl}.2", stages[2])
    if "proto" in det:     # Segment head
        pr = det["proto"]
        _put_conv(sd, "model.23.proto.cv1", pr["cv1"])
        sd["model.23.proto.upsample.weight"] = np.asarray(
            pr["up_w"], np.float32).transpose(2, 3, 0, 1)   # HWIO→IOHW
        sd["model.23.proto.upsample.bias"] = np.asarray(
            pr["up_b"], np.float32)
        _put_conv(sd, "model.23.proto.cv2", pr["cv2"])
        _put_conv(sd, "model.23.proto.cv3", pr["cv3"])
    return sd


def export_onnx(params: Mapping[str, Any], path, arch: str = "v8") -> None:
    """Export a param pytree as an ultralytics-named ONNX weights carrier."""
    save_onnx(params_to_state_dict(params, arch), path)
