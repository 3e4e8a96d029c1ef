"""Dependency-free ONNX serializer and evaluator for the R2L forward.

A copy of ``r2l_tpu/onnx_writer.py`` (numpy only), which the port may not
import. The reference ships its student as a ``.onnx`` file (``save_onnx``,
reference ``main.py:831-853``); where neither the ``onnx`` package nor
``onnxruntime`` is installed, torch's exporter cannot serialize, so this
module writes the artifact itself:

  * ``build_r2l_onnx(params, cfg)`` builds an ONNX ``ModelProto`` (IR
    version 7, opset 11, the reference's ``opset_version``) of the R2L
    head, body and tail as ``Gemm``/``Relu``/``LeakyRelu``/``Mul``/``Add``/
    ``Sigmoid`` nodes with a symbolic batch dimension, from the JAX-layout
    numpy tree (``models.params_to_jax``), through a protobuf wire-format
    encoder (varints and length-delimited fields). Its bytes equal
    ``r2l_tpu``'s for the same tree (the producer name too).
  * ``run_onnx(blob, x)`` decodes such a file and runs it with numpy: the
    reference's onnxruntime check (``main.py:857-885``) where onnxruntime
    is absent.

Field numbers and enum values follow the public ``onnx/onnx.proto`` (IR
v7): ModelProto{ir_version=1, producer_name=2, producer_version=3,
model_version=5, graph=7, opset_import=8}, GraphProto{node=1, name=2,
initializer=5, input=11, output=12}, NodeProto{input=1, output=2, name=3,
op_type=4, attribute=5}, AttributeProto{name=1, f=2, i=3, type=20; FLOAT=1,
INT=2}, TensorProto{dims=1, data_type=2, name=8, raw_data=9; FLOAT=1},
ValueInfoProto{name=1, type=2}, TypeProto{tensor_type=1},
TypeProto.Tensor{elem_type=1, shape=2}, TensorShapeProto{dim=1},
Dimension{dim_value=1, dim_param=2}.
"""
from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format encoder (the subset ONNX needs: varint + bytes)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # protobuf encodes negative int64 as 10-byte two's complement
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def f_bytes(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def f_string(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode("utf-8"))


def f_float(field: int, v: float) -> bytes:  # wire type 5 = fixed32
    return _key(field, 5) + struct.pack("<f", v)


# ---------------------------------------------------------------------------
# ONNX message builders
# ---------------------------------------------------------------------------

FLOAT = 1  # TensorProto.DataType.FLOAT

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT = 1, 2


def tensor(name: str, arr: np.ndarray) -> bytes:
    """TensorProto with raw_data (little-endian f32)."""
    arr = np.ascontiguousarray(arr, dtype="<f4")
    msg = b"".join(f_varint(1, int(d)) for d in arr.shape)
    msg += f_varint(2, FLOAT)
    msg += f_string(8, name)
    msg += f_bytes(9, arr.tobytes())
    return msg


def attr_f(name: str, v: float) -> bytes:
    return f_string(1, name) + f_float(2, v) + f_varint(20, ATTR_FLOAT)


def attr_i(name: str, v: int) -> bytes:
    return f_string(1, name) + f_varint(3, v) + f_varint(20, ATTR_INT)


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    msg = b"".join(f_string(1, i) for i in inputs)
    msg += b"".join(f_string(2, o) for o in outputs)
    if name:
        msg += f_string(3, name)
    msg += f_string(4, op_type)
    msg += b"".join(f_bytes(5, a) for a in attrs)
    return msg


def value_info(name: str, dims: Sequence) -> bytes:
    """ValueInfoProto for a float tensor; str dims become dim_param
    (the dynamic batch axis, reference `main.py:1111-1115`)."""
    shape = b""
    for d in dims:
        dim = (f_string(2, d) if isinstance(d, str)
               else f_varint(1, int(d)))
        shape += f_bytes(1, dim)
    tensor_type = f_varint(1, FLOAT) + f_bytes(2, shape)
    type_proto = f_bytes(1, tensor_type)
    return f_string(1, name) + f_bytes(2, type_proto)


def graph(nodes: Sequence[bytes], name: str, initializers: Sequence[bytes],
          inputs: Sequence[bytes], outputs: Sequence[bytes]) -> bytes:
    msg = b"".join(f_bytes(1, n) for n in nodes)
    msg += f_string(2, name)
    msg += b"".join(f_bytes(5, t) for t in initializers)
    msg += b"".join(f_bytes(11, vi) for vi in inputs)
    msg += b"".join(f_bytes(12, vi) for vi in outputs)
    return msg


def model(graph_msg: bytes, opset: int = 11, ir_version: int = 7,
          producer: str = "r2l_tpu") -> bytes:
    opset_id = f_varint(2, opset)  # default domain "" omitted
    return (f_varint(1, ir_version)
            + f_string(2, producer)
            + f_string(3, "0")
            + f_varint(5, 1)
            + f_bytes(7, graph_msg)
            + f_bytes(8, opset_id))


# ---------------------------------------------------------------------------
# R2L graph construction
# ---------------------------------------------------------------------------


def _f32_tree(tree):
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f32_tree(v) for v in tree]
    return np.asarray(tree, np.float32)


def build_r2l_onnx(params: dict, cfg) -> bytes:
    """Serialize the R2L forward (``models.R2L``, JAX's ``apply_r2l``,
    reference ``NeRF_v3_2.forward``, `model/nerf_raybased.py:539-544`) as an
    ONNX ModelProto. Weights go in as [in, out] ``Gemm`` B-operands (default
    transB=0), so ``y = x @ W + b`` exactly like the pytree forward."""
    host = _f32_tree(params)
    nodes: list = []
    inits: list = []
    counter = [0]

    def fresh(tag: str) -> str:
        counter[0] += 1
        return f"{tag}_{counter[0]}"

    def gemm(x_name: str, w: np.ndarray, b: np.ndarray, tag: str) -> str:
        wn, bn, out = tag + "_w", tag + "_b", fresh(tag)
        inits.append(tensor(wn, w))
        inits.append(tensor(bn, b))
        nodes.append(node("Gemm", [x_name, wn, bn], [out], name=tag))
        return out

    def activation(x_name: str, kind: str, tag: str) -> str:
        kind = kind.lower()
        if kind == "none":
            return x_name
        out = fresh(tag)
        if kind == "relu":
            nodes.append(node("Relu", [x_name], [out], name=tag))
        elif kind == "lrelu":
            nodes.append(node("LeakyRelu", [x_name], [out], name=tag,
                              attrs=[attr_f("alpha", 0.01)]))
        else:
            raise NotImplementedError(f"activation {kind!r}")
        return out

    h = gemm("input", host["head"]["w"], host["head"]["b"], "head")
    h = activation(h, cfg.act, "head_act")
    out = h

    if cfg.body_arch == "resmlp":
        bw, bb = host["body"]["w"], host["body"]["b"]
        nb, nl = bw.shape[0], bw.shape[1]
        for i in range(nb):
            blk_in, cur = out, out
            for j in range(nl):
                cur = gemm(cur, bw[i, j], bb[i, j], f"block{i}_lin{j}")
                if j < nl - 1:
                    cur = activation(cur, cfg.inact, f"block{i}_inact{j}")
            if cfg.res_scale != 1.0:
                sn = f"block{i}_res_scale"
                inits.append(tensor(sn, np.float32(cfg.res_scale)))
                scaled = fresh(f"block{i}_scaled")
                nodes.append(node("Mul", [cur, sn], [scaled]))
                cur = scaled
            added = fresh(f"block{i}_res")
            nodes.append(node("Add", [cur, blk_in], [added]))
            out = activation(added, cfg.outact, f"block{i}_outact")
    else:  # plain-MLP body (supports --layerwise_netwidths)
        for i, layer in enumerate(host["body"]):
            out = gemm(out, layer["w"], layer["b"], f"mlp{i}")
            out = activation(out, cfg.act, f"mlp{i}_act")

    if cfg.use_residual:
        res = fresh("global_res")
        nodes.append(node("Add", [out, h], [res]))
        out = res

    out = gemm(out, host["tail"]["w"], host["tail"]["b"], "tail")
    if not cfg.linear_tail:
        rgb = fresh("sigmoid")
        nodes.append(node("Sigmoid", [out], [rgb]))
        out = rgb
    # rename final output to the stable public name
    nodes[-1] = _rename_last_output(nodes[-1], "rgb")

    g = graph(nodes, "r2l",
              initializers=inits,
              inputs=[value_info("input", ["batch", cfg.input_dim])],
              outputs=[value_info("rgb", ["batch", cfg.output_dim])])
    return model(g)


def _rename_last_output(node_msg: bytes, new_name: str) -> bytes:
    """Rewrite field 2 (output) of an encoded NodeProto to ``new_name``
    (every node we emit has exactly one output)."""
    fields = list(_iter_fields(node_msg))
    out = bytearray()
    for fnum, wire, payload in fields:
        if fnum == 2 and wire == 2:
            out += f_string(2, new_name)
        else:
            out += _reencode(fnum, wire, payload)
    return bytes(out)


# ---------------------------------------------------------------------------
# wire-format decoder + mini evaluator (the in-env parity check)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, payload) over an encoded message.
    payload is int for varint/fixed, bytes for length-delimited."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        elif wire == 1:
            val = int.from_bytes(buf[pos:pos + 8], "little")
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fnum, wire, val


def _reencode(fnum: int, wire: int, payload) -> bytes:
    if wire == 0:
        return f_varint(fnum, payload)
    if wire == 2:
        return f_bytes(fnum, payload)
    if wire == 5:
        return _key(fnum, 5) + int(payload).to_bytes(4, "little")
    return _key(fnum, 1) + int(payload).to_bytes(8, "little")


def _decode_tensor(buf: bytes):
    dims, dtype, name, raw = [], None, "", b""
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            dims.append(val)
        elif fnum == 2:
            dtype = val
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    if dtype != FLOAT:
        raise NotImplementedError(f"tensor dtype {dtype}")
    return name, np.frombuffer(raw, "<f4").reshape(dims)


def _decode_node(buf: bytes):
    inputs, outputs, op, attrs = [], [], "", {}
    for fnum, _, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(val.decode())
        elif fnum == 2:
            outputs.append(val.decode())
        elif fnum == 4:
            op = val.decode()
        elif fnum == 5:
            name = fval = ival = None
            for afn, awire, aval in _iter_fields(val):
                if afn == 1:
                    name = aval.decode()
                elif afn == 2:
                    fval = struct.unpack("<f", int(aval).to_bytes(4, "little"))[0]
                elif afn == 3:
                    ival = aval
            attrs[name] = fval if fval is not None else ival
    return op, inputs, outputs, attrs


def run_onnx(blob: bytes, x: np.ndarray) -> np.ndarray:
    """Decode an ONNX blob produced by this module and execute it with
    numpy. Supports the ops ``build_r2l_onnx`` emits (Gemm/Relu/
    LeakyRelu/Sigmoid/Add/Mul) — the reference's ``check_onnx`` analog
    (`main.py:857-885`) for environments without onnxruntime."""
    graph_buf = None
    for fnum, _, val in _iter_fields(blob):
        if fnum == 7:
            graph_buf = val
    if graph_buf is None:
        raise ValueError("no GraphProto in model")

    env: dict = {}
    nodes = []
    input_name = output_name = None
    for fnum, _, val in _iter_fields(graph_buf):
        if fnum == 1:
            nodes.append(_decode_node(val))
        elif fnum == 5:
            name, arr = _decode_tensor(val)
            env[name] = arr
        elif fnum == 11:
            input_name = next(v.decode() for f, _, v in _iter_fields(val)
                              if f == 1)
        elif fnum == 12:
            output_name = next(v.decode() for f, _, v in _iter_fields(val)
                               if f == 1)

    env[input_name] = np.asarray(x, np.float32)
    for op, inputs, outputs, attrs in nodes:
        a = [env[i] for i in inputs]
        if op == "Gemm":
            alpha = attrs.get("alpha", 1.0)
            beta = attrs.get("beta", 1.0)
            A = a[0].T if attrs.get("transA", 0) else a[0]
            B = a[1].T if attrs.get("transB", 0) else a[1]
            y = alpha * (A @ B)
            if len(a) > 2:
                y = y + beta * a[2]
        elif op == "Relu":
            y = np.maximum(a[0], 0.0)
        elif op == "LeakyRelu":
            al = attrs.get("alpha", 0.01)
            y = np.where(a[0] > 0, a[0], al * a[0])
        elif op == "Sigmoid":
            y = 1.0 / (1.0 + np.exp(-a[0]))
        elif op == "Add":
            y = a[0] + a[1]
        elif op == "Mul":
            y = a[0] * a[1]
        else:
            raise NotImplementedError(f"op {op}")
        env[outputs[0]] = np.asarray(y, np.float32)
    return env[output_name]
