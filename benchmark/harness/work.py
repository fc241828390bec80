"""The work a cell asks for, as functions of its configuration's shapes,
never counted from the program: model FLOPs (2 a multiply-add, for the
convolutions, dense layers and batched products; frozen parts forward
only, trained parts forward and backward, 3x), the bytes of a kernel
call (each input read once and each output written once) and the chip's
published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)."""

from __future__ import annotations

PEAKS = {
    "bfloat16": 989e12,   # FLOP/s, tensor cores
    "float32": 67e12,     # outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"bfloat16": 2, "float32": 4}


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet18_macs(h: int, w: int, out_dim: int) -> int:
    """Multiply-adds of one image through ResNet-18 (stem 7x7/2, max pool
    3/2, four stages of two basic blocks, the fc)."""
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    macs = 3 * 49 * 64 * h * w
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    c_in = 64
    for stage in range(4):
        c_out = 64 * 2 ** stage
        for block in range(2):
            s = 2 if stage > 0 and block == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            macs += c_in * 9 * c_out * ho * wo + c_out * 9 * c_out * ho * wo
            if c_in != c_out or s != 1:
                macs += c_in * c_out * ho * wo
            h, w, c_in = ho, wo, c_out
    return macs + 512 * out_dim


def resnet1d_se_macs(t: int, c_in: int, f: int, out_dim: int) -> int:
    """Multiply-adds of one signal through ResNet1D-SE (stem 7/2, max pool
    3/2, three SE blocks, the 4f -> 64 -> out_dim head)."""
    t = _out(t, 7, 2, 3)
    macs = c_in * 7 * f * t
    t = _out(t, 3, 2, 1)
    c = f
    for c_out, s in ((f, 1), (2 * f, 2), (4 * f, 2)):
        to = _out(t, 3, s, 1)
        macs += c * 3 * c_out * to + c_out * 3 * c_out * to
        if c != c_out or s != 1:
            macs += c * c_out * to
        r = max(1, c_out // 16)
        macs += 2 * c_out * r
        t, c = to, c_out
    return macs + 4 * f * 64 + 64 * out_dim


def tabnet_macs(n_in: int, d: int, steps: int = 3, n_shared: int = 2,
                n_independent: int = 2) -> int:
    """Multiply-adds of one row through TabNet (n_d = n_a = d)."""
    w = 2 * d

    def feat():
        shared = sum((n_in if i == 0 else w) * 2 * w for i in range(n_shared))
        return shared + n_independent * w * 2 * w

    return feat() + steps * (d * n_in + feat()) + d * d


def fusion_head_macs(m: dict) -> int:
    """One row through the head the fusion step trains: the three branch
    classifiers and the hidden-layer head."""
    width = m["image_dim"] + m["signal_dim"] + m["clinical_dim"]
    c = m["num_classes"]
    return width * c + width * m["fusion_hidden"] + m["fusion_hidden"] * c


def fusion_encoder_macs(cfg: dict) -> int:
    m, i = cfg["model"], cfg["inputs"]
    return (resnet18_macs(i["image"][1], i["image"][2], m["image_dim"])
            + resnet1d_se_macs(i["signal_len"], m["signal_input_channels"],
                               m["signal_base_filters"], m["signal_dim"])
            + tabnet_macs(m["clinical_in_features"], m["clinical_dim"]))


def transformer_macs(m: dict) -> int:
    """One sequence through the 1-D Transformer."""
    t, d, ff = m["seq_len"], m["d_model"], m["dim_feedforward"]
    layer = t * d * 3 * d + 2 * t * t * d + t * d * d + 2 * t * d * ff
    return (m["input_channels"] * m["conv_kernel"] * d * t
            + m["num_layers"] * layer + d * m["head_hidden"]
            + m["head_hidden"] * m["num_classes"])


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one train step of `batch` rows."""
    kind = cfg["reference"]
    if kind == "fusion":
        return 2.0 * batch * (fusion_encoder_macs(cfg)
                              + 3 * fusion_head_macs(cfg["model"]))
    if kind == "transformer1d":
        return 2.0 * batch * 3 * transformer_macs(cfg["model"])
    raise ValueError(kind)


def se_shapes(signal_len: int, f: int) -> list:
    """(C, T) of the three SE gates of ResNet1D-SE on signals of
    `signal_len` samples with base width f."""
    t = _out(_out(signal_len, 7, 2, 3), 3, 2, 1)
    out = [(f, t)]
    for c in (2 * f, 4 * f):
        t = _out(t, 3, 2, 1)
        out.append((c, t))
    return out


def se_forward_bytes(b: int, c: int, t: int, esize: int,
                     residual: bool = False) -> int:
    """The SE gate's forward: x in, out out, the two dense layers' weights
    and biases in; with `residual` also the (2, B, C) float32 means and
    gate that a backward would read."""
    r = max(1, c // 16)
    weights = (r * c + r + c * r + c) * esize
    return 2 * b * c * t * esize + weights + (8 * b * c if residual else 0)


def least_seconds(bytes_: float, flops: float = 0.0,
                  peak: str = "float32") -> float:
    """The least time the chip could take: the larger of the bytes over
    the HBM bandwidth and the FLOPs over the peak."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / PEAKS[peak])
