"""Which parts of a configuration the hand-written kernels can take, from its
shapes alone.

The kernels carry fixed limits (ROADMAP queue B): the cross attention of B1,
B2, B5 and B7 takes every head width 1 <= D = heads * dim_head <=
ATTENTION_MAX_D (1,024; up to 512 one kernel instance a tile of 32, 64,
128, 256 or 512 columns, the smallest that holds D, past it a thread-block
cluster of ceil(D / 128) blocks); the fused layer kernels take
widths up to 2,048 (the LayerNorm's row, the latent and a launch's packed
input rows up to 1,024; B2's output layer in column passes of at most 256
pairs) and 3 to 10 products a launch; B3 and B6 take k <= min(n, 256) neighbours of at most
256 channels (B6 keeps a neighbour's slot in a byte; past k = 64 the
selection is the radix select alone), on clouds of any size (16 distance
rows of the cloud in shared memory up to 3,200 points at 128 features,
walked in chunks past it) and batches of any size (B6's backward builds its reverse
lists in scratch linear in the rows, a group of items at a time); B8 takes
any cloud (its level clouds in shared memory up to 12,662 points over
PAConv's four levels, past it in registers, a shared tier and L2), and B9
too (in shared memory up to 4,458 points, read from L2 past it; k <= 256). A
configuration outside them runs, part by part, the path the JAX package
takes off the TPU, and the other parts stay on their kernels. At
dulcet-universe's other widths the attention's limit is not the first to
bind past D = 872: the coupling's packed input rows [x1 | extra | pad |
cond] pass 1,024 there (from D = 873 the stack goes plain), and the
augmenter's net's at D = 1,024:

* "stack" (B1, B5, B7): `flow_layer_cuda.folded_scan_core` for eval and
  training, the unfolded reverse for sampling;
* "augmenter" (B2): the unfused augmenter;
* "encoder": the DGCNN's gather formulation in eval and training (B4 and
  B3, B6), or PAConv's plain FPS and kNN grouping (B8, B9).

`model_routes(config)` gives each part "kernels" or "plain: <reason>". It
needs no CUDA device and no compiled library, and reads no batch size:
the shared-memory sizes are Python mirrors of the library's own formulas
(`knn_smem_bytes`, `sa_select_smem`, `sa_gather_smem`), which a card test
holds equal to `fc_knn_edge_max_smem`, `fc_sa_select_smem` and
`fc_sa_gather_smem`. The kernels keep their own checks: a shape these
gates let through and a kernel refuses still raises.

The routes are the shapes' verdict only. The compute dtype and the
nonlinearity are the model's policy on top of them (bf16 and GELU for B1,
B2, B5 and B7; `FlowCompareModel._kernel_route`).
"""

from __future__ import annotations

from .encoders.dgcnn import _EDGE_DIMS
from .encoders.paconv import NSAMPLE, SA_MLPS
from .ops._build import ATTENTION_MAX_D, KNN_MAX_K, SMEM_LIMIT
from .ops.dgcnn_cuda import dgcnn_tail_plan
from .ops.edgeconv_cuda import knn_smem_bytes
from .ops.flow_layer_cuda import (FUSED_LIMITS_TEXT, augment_net_plan, fused_route,
                                  packed_input_layout)
from .ops.sa_group_cuda import sa_select_smem

KNN_MAX_C = 256   # B3 / B6 channels (KNN_MAX_K: B3 / B6 / B9 neighbours)

# csrc/sa_group.cu: gather warps, elements of a gather tile
_GA_WARPS, _GA_TILE = 4, 2048


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def sa_gather_smem(c: int, k: int, esize: int) -> int:
    """B9's gather of rows of 3 + c elements of esize bytes, k a group
    (`fc_sa_gather_smem`): a tile of rows and 32 indices a warp."""
    w = 3 + c
    rows = min(k, min(32, max(8, (_GA_TILE // w) & ~7)))
    return _GA_WARPS * (_up(rows * w * esize + 16, 16) + 32 * 4)


def _mlp_shapes(in_dim: int, hidden, out_dim: int) -> list:
    """(K, N) of each product of `core.mlp.init_mlp`'s MLP."""
    dims = [in_dim, *hidden, out_dim]
    return list(zip(dims[:-1], dims[1:]))


def _head_width(c: dict) -> int:
    return c["cross_heads"] * c["cross_dim_head"]


def stack_shapes(c: dict) -> dict:
    """The folded stack's product shapes as `_CouplingChain` and B5 see
    them: the pre-MLP's and q's (None for the global conditioner), the
    coupling MLP's (its first over the packed rows [x1 | extra | pad |
    cond], cond the attention's D columns or the embedding's E), the
    LinearLU's."""
    lat = c["latent_dim"]
    split = lat // 2
    cond = c["input_embedding_dim"] if c["global"] else _head_width(c)
    _, xc, _ = packed_input_layout(split, c["extra_context_dim"], cond)
    cpl = _mlp_shapes(xc + cond, c["hidden_dims"], 2 * (lat - split))
    pre = q = None
    if not c["global"]:
        pre = _mlp_shapes(split, c["pre_attention_mlp_hidden_dims"], c["attn_input_dim"])
        q = (c["attn_input_dim"], _head_width(c))
    return {"pre": pre, "q": q, "cpl": cpl, "tail": (lat, lat), "split": split, "lat": lat}


def _attention_reason(c: dict) -> str:
    d = _head_width(c)
    if not 1 <= d <= ATTENTION_MAX_D:
        return (f"plain: attention head width {c['cross_heads']} x {c['cross_dim_head']} = {d} "
                f"(the cross-attention kernels take 1 <= D <= {ATTENTION_MAX_D})")
    return ""


def stack_route(c: dict) -> str:
    """B1, B5 and B7 on the folded stack: the attention's head width, and
    `fused_route`'s tests for the conditioner and the coupling."""
    s = stack_shapes(c)
    if not c["global"]:
        reason = _attention_reason(c)
        if reason:
            return reason
    route = fused_route(s["pre"], s["q"], s["cpl"], s["tail"], s["split"], s["lat"])
    if not c["global"] and not route["conditioner"]:
        return f"plain: the conditioner's products {s['pre'] + [s['q']]} ({FUSED_LIMITS_TEXT})"
    if not route["coupling"]:
        return f"plain: the coupling's products {s['cpl'] + [s['tail']]} ({FUSED_LIMITS_TEXT})"
    return "kernels"


def augmenter_route(c: dict) -> str:
    """B2, the attention-preconditioned augmenter: its head width, its
    conditioner's `fused_route` test and `augment_net_plan`."""
    if c["latent_dim"] == c["input_dim"]:
        return "plain: the identity augmenter has no kernel"
    if c["augmenter_dist"] != "ConditionalNormal" or not c["use_attn_augment"]:
        return "plain: only the attention-preconditioned ConditionalNormal has a kernel"
    reason = _attention_reason(c)
    if reason:
        return reason
    in_dim, d = c["input_dim"], _head_width(c)
    pre = _mlp_shapes(in_dim, c["hidden_dims"], c["attn_input_dim"])
    q = (c["attn_input_dim"], d)
    if not fused_route(pre, q, [], (0, 0), in_dim, 0)["conditioner"]:
        return f"plain: the augmenter's conditioner {pre + [q]} ({FUSED_LIMITS_TEXT})"
    aug = c["latent_dim"] - in_dim
    _, xc, _ = packed_input_layout(in_dim, c["extra_context_dim"], d)
    net = _mlp_shapes(xc + d, c["net_augmenter_dist_hidden_dims"], 2 * aug)
    try:
        augment_net_plan(net, xc + d, aug)
    except ValueError as err:
        return f"plain: {err}"
    return "kernels"


def _dgcnn_route(c: dict) -> str:
    n, k = c["n_samples_context"], c["n_neighbors"]
    if not 1 <= k <= min(n, KNN_MAX_K):
        return (f"plain: n_neighbors {k} (B3 and B6 take 1 <= k <= min(n, {KNN_MAX_K}), "
                f"n = {n})")
    couts = [cout for _, cout in _EDGE_DIMS]
    if max(couts) > KNN_MAX_C:
        return f"plain: EdgeConv widths {couts} (B3 and B6 take <= {KNN_MAX_C} channels)"
    in_dim = c["input_dim"]
    # the stages' kNN features: B4's first stage reads the cloud cast into
    # whole 8-column rows, B6's the cloud padded to an even width
    cqs = [_up(in_dim, 8), _up(in_dim, 2)] + [cin for cin, _ in _EDGE_DIMS[1:]]
    smem = max(knn_smem_bytes(n, cq) for cq in cqs)
    if smem > SMEM_LIMIT:
        return (f"plain: clouds of {n} points need {smem} bytes of shared memory in B3 and B6 "
                f"(more than {SMEM_LIMIT})")
    head = None if c["global"] else _mlp_shapes(512, c["hidden_dims_embedder_out"],
                                                c["input_embedding_dim"])
    try:
        dgcnn_tail_plan((sum(couts), 512), head)
    except ValueError as err:
        return f"plain: {err}"
    return "kernels"


def _paconv_route(c: dict) -> str:
    n = c["n_samples_context"]
    if NSAMPLE > KNN_MAX_K:
        return f"plain: PAConv's k = {NSAMPLE} (B9 takes k <= {KNN_MAX_K})"
    smem = sa_select_smem(n)
    if smem > SMEM_LIMIT:
        return (f"plain: clouds of {n} points need {smem} bytes of shared memory in B9's "
                f"selection (more than {SMEM_LIMIT})")
    esize = 2 if c.get("compute_dtype") == "bfloat16" else 4
    widths = [spec[0] for spec in SA_MLPS(c["input_dim"] - 3)]
    smem = max(sa_gather_smem(w, NSAMPLE, esize) for w in widths)
    if smem > SMEM_LIMIT:
        return (f"plain: SA features {widths} need {smem} bytes of shared memory in B9's "
                f"gather (more than {SMEM_LIMIT})")
    return "kernels"


def encoder_route(c: dict) -> str:
    """The encoder's kernels: the DGCNN's B4 (eval; B3 inside) and B6
    (training), or PAConv's B8 and B9."""
    kind = c["input_embedder"]
    if kind == "PAConv":
        return _paconv_route(c)
    if kind in ("DGCNNembedder", "DGCNNembedderGlobal"):
        return _dgcnn_route(c)
    return "plain: the identity embedder has no kernel"


def model_routes(c: dict) -> dict:
    """{"stack", "augmenter", "encoder"} -> "kernels" or "plain: <reason>",
    for a derived config (`configs.presets.derive`)."""
    return {"stack": stack_route(c), "augmenter": augmenter_route(c), "encoder": encoder_route(c)}
