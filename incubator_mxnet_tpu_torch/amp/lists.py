"""AMP op lists (JAX counterpart: ``amp/lists.py``; reference:
``python/mxnet/amp/lists/symbol_fp16.py``).

FP16_FP32_FUNCS: the matmul- and convolution-class ops whose float32 inputs
``amp.init()`` casts to the target dtype (bf16 or fp16 tensor cores).
FP32_FUNCS: numerically sensitive ops kept in float32.
WIDEST_TYPE_CASTS: ops that follow their widest input (torch's type
promotion does that by itself; listed for parity).
The names the port's ``mx.nd`` lacks (the ``interleaved_matmul_*`` ops)
are skipped by ``init()``.
"""

FP16_FP32_FUNCS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "linalg_gemm2",
    "dot_product_attention",
    "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk",
    "interleaved_matmul_encdec_valatt",
    "RNN",
]

FP32_FUNCS = [
    "BatchNorm",
    "LayerNorm",
    "GroupNorm",
    "InstanceNorm",
    "L2Normalization",
    "softmax",
    "log_softmax",
    "masked_softmax",
    "SoftmaxOutput",
    "softmax_cross_entropy",
    "exp", "log", "log2", "log10", "log1p",
    "sum", "mean", "prod", "norm", "logsumexp",
    "Dropout",
]

WIDEST_TYPE_CASTS = [
    "add_n", "concat", "stack", "where", "broadcast_add", "broadcast_mul",
]
