"""The yardstick's arithmetic: published H100 peaks, the least time each of
the port's kernel calls could take (its roofline bound), and model FLOPs
from shapes. A frozen copy of ``chip_smoke.py``'s ``PEAK_FLOPS``,
``HBM_BYTES_PER_S``, ``bound``, ``bound_dw``, ``bound_mahalanobis`` and
``bound_attention``, with one correction: a backward call is charged for
the weight gradients only when it computes them (``weight_grads``).

A bound counts the operations the call needs and the bytes it must move,
each input read once and each output written once, and takes the larger of
operations over the peak and bytes over the memory rate. FLOPs are 2 a
multiply-add.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# One H100 SXM (NVIDIA's data sheet, dense peaks at the full 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
CLASS_SLOTS = 16  # the port's class axis (MAX_WAY): a head's padded classes

# Device kernels the port's own csrc/ defines (demangled names), for the
# device time of its launches. The anonymous namespace keeps ATen's
# vectorized_layer_norm_kernel out of the LayerNorm pattern.
PORT_KERNELS = (
    r"fused_qkv_attention_(f32|wgmma)_kernel|fused_mlp_block_\w*kernel|"
    r"qkv_attention_bwd_f32_kernel|qkv_recompute_kernel|attention_bwd_mma_kernel|"
    r"attention_backward_kernel|mlp_bwd_hidden\w*kernel|sgemm_grads_kernel|grads_kernel|"
    r"sum_runs_kernel|sum_partials_kernel|colsum_partial_kernel|gemm_fma_kernel|"
    r"namespace\)::layer_norm_(backward_)?kernel|tiny_attention\w*kernel|"
    r"mahalanobis_(partial|finish)_kernel|fused_dw_rows_kernel")


def roofline_s(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def _elem(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def bound_vit(name: str, b: int, s: int, d: int, dtype: str, weight_grads: bool = True) -> float:
    """Seconds, one call of kernel ``name`` on B = b sequences of S = s
    tokens of width d (hidden 4d): A ``fused_qkv_attention``, B
    ``fused_mlp_block``, #4 ``fused_qkv_attention_bwd``, #6
    ``fused_mlp_block_bwd``."""
    rows, h, e = b * s, 4 * d, _elem(dtype)
    if name == "fused_qkv_attention":        # qkv product, q k^T and p v a head
        flops = 2 * rows * d * 3 * d + 4 * b * s * s * d
        nbytes = e * (2 * rows * d + 3 * d * d + 3 * d)
    elif name == "fused_mlp_block":          # fc1 and fc2
        flops = 4 * rows * d * h
        nbytes = e * (2 * rows * d + 2 * d * h) + 4 * (3 * d + h)
    elif name == "fused_qkv_attention_bwd":  # qkv recompute, dx (dW), 5 attention products
        flops = (3 if weight_grads else 2) * 2 * rows * d * 3 * d + 10 * b * s * s * d
        nbytes = e * (3 * rows * d + 3 * d * d + 3 * d)
        if weight_grads:
            nbytes += 4 * (3 * d * d + 3 * d)
    elif name == "fused_mlp_block_bwd":      # fc1 recompute, dh, dxn (dW1, dW2)
        flops = (5 if weight_grads else 3) * 2 * rows * d * h
        nbytes = e * (3 * rows * d + 2 * d * h) + 4 * (3 * d + h) + 4 * 2 * d
        if weight_grads:
            nbytes += 4 * (2 * d * h + h + d)
    else:
        raise ValueError(name)
    return roofline_s(flops, nbytes, PEAK_FLOPS[dtype])


def bound_dw(n: int, h: int, c: int, k: int, dtype: str) -> float:
    """One depthwise-tail call (#8) on (n, h, h, c): 2 K^2 FLOPs an output on
    the CUDA cores; the activation read and the output written once, f32
    taps and affines."""
    return roofline_s(2 * k * k * n * h * h * c, _elem(dtype) * 2 * n * h * h * c
                      + 4 * (k * k * c + 4 * c), PEAK_FLOPS["float32"])


def bound_mahalanobis(m: int, d: int, c: int, real: int) -> float:
    """One Mahalanobis-logits call (#7), ``real`` of its ``c`` classes real:
    2 M D^2 FLOPs a real class; features, the real classes' means and
    precisions read and all M x C logits written once."""
    return roofline_s(2 * m * d * d * real, 4 * (m * d + real * d + real * d * d + m * c),
                      PEAK_FLOPS["float32"])


# ----------------------------------------------------------- model FLOPs ----
def vit_frame_flops(a: dict) -> float:
    """Forward FLOPs of one frame through a class-token ViT."""
    d, p, hid = a["hidden_size"], a["patch_size"], a["intermediate_size"]
    patches = (a["image_size"] // p) ** 2
    s = patches + 1
    layer = 2 * s * d * 3 * d + 4 * s * s * d + 2 * s * d * d + 2 * 2 * s * d * hid
    return 2 * patches * p * p * 3 * d + a["num_hidden_layers"] * layer


def effnet_blocks(a: dict) -> List[Tuple]:
    """(type, in, out, k, stride, mid, SE width, input size) a block."""
    size = -(-a["image_size"] // 2)  # after the stride-2 stem
    cin, out = a["stem_channels"], []
    for btype, repeats, k, stride, exp, cout, se in a["arch"]:
        for bi in range(repeats):
            s = stride if bi == 0 else 1
            mid = cin if btype == "ds" else int(cin * exp)
            out.append((btype, cin, cout, k, s, mid, max(1, int(cin * se)), size))
            size = -(-size // s)
            cin = cout
    return out


def effnet_frame_flops(a: dict) -> float:
    """Forward FLOPs of one frame through the EfficientNet's convolutions
    (stem, expansions, depthwise, SE, projections, head)."""
    size = -(-a["image_size"] // 2)
    flops, last = 2 * size * size * 27 * a["stem_channels"], a["stem_channels"]
    for btype, cin, cout, k, s, mid, rd, h in effnet_blocks(a):
        size = -(-h // s)
        if btype == "ir":
            flops += 2 * h * h * cin * mid
        flops += 2 * size * size * k * k * mid + 2 * 2 * mid * rd + 2 * size * size * mid * cout
        last = cout
    return flops + 2 * size * size * last * a["head_channels"]


def effnet_dw_tails(a: dict) -> Dict[Tuple[int, int, int], int]:
    """(H, C, K) of each stride-1 depthwise tail (#8's calls) -> count a
    forward."""
    tails: Dict[Tuple[int, int, int], int] = {}
    for btype, _, _, k, s, mid, _, h in effnet_blocks(a):
        if s == 1:
            tails[(h, mid, k)] = tails.get((h, mid, k), 0) + 1
    return tails


def set_encoder_frame_flops(size: int) -> float:
    """Forward FLOPs of the DeepSets set encoder (5 x conv3x3-64, pool 2)
    on one frame."""
    flops, cin = 0.0, 3
    for _ in range(5):
        flops += 2 * size * size * 9 * cin * 64
        size, cin = size // 2, 64
    return flops


def mahalanobis_head_flops(n_ctx: int, m: int, d: int, way: int) -> float:
    """The SimpleCNAPs head: class and task covariances, a D^3 inverse a
    real class (LU and solve, 2 D^3), and M queries' quadratic forms."""
    return 2 * n_ctx * d * d * 2 + way * 2 * d ** 3 + 2 * m * way * (d * d + d)


def proto_head_flops(n_ctx: int, m: int, d: int, way: int) -> float:
    return 2 * n_ctx * d + 2 * m * way * d


SIZE_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket_rows(n: int) -> int:
    """The rows a set of ``n`` clips is padded to (the port's episode
    buckets), which the extractor embeds."""
    return next(b for b in SIZE_BUCKETS if n <= b)


def chunks(rows: int, batch: int) -> List[int]:
    """The extractor calls a run of ``rows`` rows makes, ``batch`` at most each."""
    return [min(batch, rows - i) for i in range(0, rows, batch)]



# --------------------------------------------- the work of a traced span ----
class Unpredicted(Exception):
    """A configuration whose kernel calls this module does not derive."""


class Work:
    """The summed roofline bounds, model FLOPs and port-kernel calls of the
    traced tasks, derived from the configuration and each task's shape
    alone: every loop module adds its tasks here."""

    def __init__(self, config: dict):
        self.a, self.dtype = config["architecture"], config["dtype"]
        self.bound_s, self.flops = 0.0, 0.0
        self.calls: Dict[str, int] = {}

    def call(self, name: str, count: int, seconds: float) -> None:
        self.calls[name] = self.calls.get(name, 0) + count
        self.bound_s += seconds

    def extractor(self, rows: int, grad: Optional[str] = None) -> None:
        """One extractor call on ``rows`` frames: the forward and, with
        ``grad`` "dx" (inputs only) or "dw" (weights too), its backward."""
        a, dtype = self.a, self.dtype
        if a["backbone"] == "vit":
            s, d, layers = (a["image_size"] // a["patch_size"]) ** 2 + 1, a["hidden_size"], \
                a["num_hidden_layers"]
            names = ("fused_qkv_attention", "fused_mlp_block")
            if grad:
                names += ("fused_qkv_attention_bwd", "fused_mlp_block_bwd")
            for name in names:
                self.call(name, layers, layers * bound_vit(name, rows, s, d, dtype,
                                                           weight_grads=grad == "dw"))
        elif a["backbone"] == "efficientnet" and grad is None:
            for (h, c, k), count in effnet_dw_tails(a).items():
                self.call("fused_dw_act", count, count * bound_dw(rows, h, c, k, dtype))
        else:
            raise Unpredicted(f"{a['backbone']} with gradients: its train-mode BatchNorm "
                              "forwards and #8's backward are not derived")

    def frames(self, n: int) -> None:
        self.flops += n * (vit_frame_flops(self.a) if self.a["backbone"] == "vit"
                           else effnet_frame_flops(self.a))

    def eval_task(self, n_ctx: int, m: int, way: int, batch: int) -> None:
        """One task of the test protocol: personalise over the context padded
        to its bucket, ``batch`` rows a call (with the set encoder when the
        configuration adapts its features), then one predict over the ``m``
        query frames, ``batch`` rows a call, and the head's logits."""
        a = self.a
        for b in chunks(bucket_rows(n_ctx), batch) + chunks(m, batch):
            self.extractor(b)
        self.frames(n_ctx + m)
        if a["adapt_features"]:
            self.flops += n_ctx * set_encoder_frame_flops(a["image_size"])
        d = feature_dim(a)
        if a["classifier"] == "proto":
            self.flops += proto_head_flops(n_ctx, m, d, way)
        elif a["classifier"] == "mahalanobis":
            self.call("mahalanobis_logits", 1, bound_mahalanobis(m, d, CLASS_SLOTS, way))
            self.flops += mahalanobis_head_flops(n_ctx, m, d, way)
        else:
            raise Unpredicted(f"the {a['classifier']} head")

    def lite_task(self, n_ctx: int, m: int, batch: int, lite: int, learn_extractor: bool) -> None:
        """One LITE task step: the context padded to its bucket without a
        graph, ``batch`` rows a call; then for each target batch the LITE
        subset and the batch's rows, forward and backward, with weight
        gradients where the extractor is learned. The head's and the
        update's FLOPs are not counted."""
        if self.a["adapt_features"] or self.a["classifier"] != "proto":
            raise Unpredicted("LITE with FiLM or a Mahalanobis head: the set encoder's, the "
                              "generator's and the head's calls in a step are not derived")
        padded = bucket_rows(n_ctx)
        for b in chunks(padded, batch):
            self.extractor(b)
        self.frames(n_ctx)
        for r in chunks(m, batch):
            for b in (min(lite, padded), r):
                self.extractor(b, "dw" if learn_extractor else "dx")
                self.frames(3 * b)

    def summary(self) -> dict:
        return {"bound_s": self.bound_s, "model_flops": self.flops,
                "expected_launches": self.calls, "peak_flops": PEAK_FLOPS[self.dtype]}


def feature_dim(a: dict) -> int:
    return a["hidden_size"] if a["backbone"] == "vit" else a["head_channels"]


def traced_work(config: dict, add) -> dict:
    """``add(work)`` adds the traced tasks to a :class:`Work`; its summary,
    or ``{"unpredicted": why}`` where the configuration's calls are not
    derived (the readers then leave the rooflines and MFU out)."""
    work = Work(config)
    try:
        add(work)
    except Unpredicted as e:
        return {"unpredicted": str(e)}
    return work.summary()
