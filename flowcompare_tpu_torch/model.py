"""The conditional flow model, eval surface: embed, log_prob, inner_loop.

Counterpart of `flowcompare_tpu/model.py` (`FlowCompareModel.init_params`,
`embed`, `log_prob`, `inner_loop`) for the configurations of this slice: a
DGCNN per-point encoder, the attention-preconditioned conditional augmenter,
sigmoid affine couplings with ActNorm and LinearLU, and a standard normal
base (dulcet-universe and swept-energy).

Parameters live in the module under the JAX package's pytree paths joined
by '.', so `state_dict()` keys are e.g. `layers.block.coupling.nn.in.w`;
layer stacks keep their leading L axis and weights are stored (in, out).
The BatchNorm running statistics are buffers under `state.`.

Precision follows the config's `compute_dtype`. Under "bfloat16" the path
is the kernels' (B4 encoder, B2 augmenter, B1 layer stack): on CUDA tensors
the port's hand-written kernels, on CPU tensors their plain versions; with
`plain=True` the plain versions run on any device (the reference the
kernels are held against). Under "float32" (the preset default) the path
is the JAX package's float32 one: the gather encoder, the unfolded
augmenter and the float32 folded scan.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .configs.presets import derive
from .core.attention import init_cross_attention
from .core.mlp import cast_tree, gelu, init_mlp
from .encoders.dgcnn import apply_dgcnn, init_dgcnn
from .flows import actnorm, augment, coupling, permuters
from .flows.distributions import standard_normal_logprob
from .ops import dgcnn_cuda, flow_layer_cuda

LOG2E = math.log2(math.e)


class ParamTree(nn.Module):
    """A nested dict/list of tensors as registered parameters (or buffers),
    named by their keys, so state_dict keys are the tree's paths."""

    def __init__(self, tree, *, buffers: bool = False):
        super().__init__()
        self._is_list = isinstance(tree, list)
        items = enumerate(tree) if self._is_list else tree.items()
        for key, value in items:
            key = str(key)
            if isinstance(value, torch.Tensor):
                if buffers:
                    self.register_buffer(key, value)
                else:
                    self.register_parameter(key, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(key, ParamTree(value, buffers=buffers))

    def tree(self):
        """The nested dict/list of the current tensors."""
        out = {**dict(self._parameters), **dict(self._buffers)}
        out.update({k: m.tree() for k, m in self._modules.items()})
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


def _tree_stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_tree_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees, 0)


class FlowCompareModel(nn.Module):
    """The flow and its parameters, initialised from a seeded generator."""

    def __init__(self, config: dict, *, generator: Optional[torch.Generator] = None,
                 plain: bool = False):
        super().__init__()
        config = derive(dict(config))
        self.config = config
        self.input_dim = config["input_dim"]
        self.latent_dim = config["latent_dim"]
        self.n_layers = config["n_flow_layers"]
        self.plain = plain
        dtype_name = config.get("compute_dtype", "float32")
        if dtype_name not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {dtype_name}")
        self.compute_dtype = torch.bfloat16 if dtype_name == "bfloat16" else None
        unsupported = {
            "input_embedder": (config["input_embedder"], "DGCNNembedder"),
            "flow_type": (config["flow_type"], "AffineCoupling"),
            "affine_scale_fn": (config["affine_scale_fn"], "sigmoid"),
            "permuter_type": (config["permuter_type"], "LinearLU"),
            "act_norm": (bool(config["act_norm"]), True),
            "augmenter_dist": (config["augmenter_dist"], "ConditionalNormal"),
            "use_attn_augment": (bool(config["use_attn_augment"]), True),
            "coupling_block_nonlinearity": (config["coupling_block_nonlinearity"], "GELU"),
        }
        for key, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(f"{key}={got!r} is not ported yet (needs {want!r})")
        if config["cif_latent_dim"] != config["latent_dim"]:
            raise NotImplementedError("CIF blocks are not ported yet")
        if self.latent_dim <= self.input_dim:
            raise NotImplementedError("the identity augmenter is not ported yet")

        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params, state = self._init_params(gen)
        for key, value in params.items():
            self.add_module(key, ParamTree(value))
        self.state = ParamTree(state, buffers=True)

    # -------------------------------------------------------------- init

    def _init_attn(self, gen):
        c = self.config
        return init_cross_attention(
            gen, out_dim=c["attn_dim"], query_dim=c["attn_input_dim"],
            context_dim=c["input_embedding_dim"], heads=c["cross_heads"],
            dim_head=c["cross_dim_head"])

    def _init_block(self, gen):
        c = self.config
        ctx = c["attn_dim"] + c["extra_context_dim"]
        return {
            "pre_attention_mlp": init_mlp(gen, self.latent_dim // 2,
                                          c["pre_attention_mlp_hidden_dims"],
                                          c["attn_input_dim"]),
            "attn": self._init_attn(gen),
            "coupling": coupling.init_affine_coupling(gen, self.latent_dim, c["hidden_dims"],
                                                      context_dim=ctx),
        }

    def _init_params(self, gen):
        c = self.config
        emb, emb_state = init_dgcnn(gen, input_dim=self.input_dim,
                                    emb_dim=c["input_embedding_dim"],
                                    out_mlp_dims=c["hidden_dims_embedder_out"])
        augmenter = {
            "pre_attn_mlp": init_mlp(gen, self.input_dim, c["hidden_dims"],
                                     c["attn_input_dim"]),
            "attn": self._init_attn(gen),
            "augment": {"net": init_mlp(
                gen, c["attn_dim"] + self.input_dim + c["extra_context_dim"],
                c["net_augmenter_dist_hidden_dims"],
                (self.latent_dim - self.input_dim) * 2)},
        }
        layers = [{"block": self._init_block(gen),
                   "permuter": permuters.init_linear_lu(self.latent_dim,
                                                        eps=c["linear_lu_eps"]),
                   "actnorm": actnorm.init_actnorm(self.latent_dim)}
                  for _ in range(self.n_layers - 1)]
        params = {
            "embedder": emb,
            "augmenter": augmenter,
            "layers": _tree_stack(layers),
            "final_block": self._init_block(gen),
        }
        return params, {"embedder": emb_state}

    def params(self) -> dict:
        """The parameter pytree (nested dicts of the module's tensors)."""
        return {k: getattr(self, k).tree()
                for k in ("embedder", "augmenter", "layers", "final_block")}

    # ------------------------------------------------------------- forward

    def embed(self, extract_0: torch.Tensor) -> torch.Tensor:
        """extract_0 (B, Nc, input_dim) -> per-point context (B, Nc, E)."""
        c = self.config
        params = self.params()["embedder"]
        state = self.state.tree()["embedder"]
        if self.compute_dtype is None:
            return apply_dgcnn(params, state, extract_0, n_neighbors=c["n_neighbors"])
        params = cast_tree(params, self.compute_dtype)
        encoder = (dgcnn_cuda.fused_dgcnn_encoder_plain if self.plain
                   else dgcnn_cuda.fused_dgcnn_encoder)
        return encoder(extract_0, params, state, k=c["n_neighbors"])

    def _folded(self, params: dict, extra_dim: int) -> dict:
        lat = self.latent_dim
        layers = dict(params["layers"])
        layers["permuter"] = permuters.linear_lu_prepare_stack(
            layers["permuter"], eps=self.config["linear_lu_eps"], dtype=self.compute_dtype)
        stacks = flow_layer_cuda.append_final_block(
            flow_layer_cuda.build_layer_stacks(layers), params["final_block"], lat)
        return flow_layer_cuda.fold_stacks(stacks, split=lat // 2, extra_dim=extra_dim)

    def log_prob(self, x: torch.Tensor, context: torch.Tensor,
                 extra_context: Optional[torch.Tensor], eps: torch.Tensor) -> torch.Tensor:
        """Per-point log p(x | context) (B, N). eps (B, N, latent - input) is
        the augmenter's standard-normal noise."""
        params = self.params()
        extra_dim = extra_context.shape[-1] if extra_context is not None else 0
        folded = self._folded(params, extra_dim)
        if self.compute_dtype is None:
            x, ldj = augment.augment_attn_forward(params["augmenter"], x, context,
                                                  extra_context, eps, nonlin=gelu)
            x, ldj = flow_layer_cuda.folded_scan_core(x, ldj.float(), context, extra_context,
                                                      folded, nonlin=gelu)
            return ldj + standard_normal_logprob(x)
        folded_aug = flow_layer_cuda.fold_augmenter(
            params["augmenter"], input_dim=self.input_dim, extra_dim=extra_dim)
        if self.plain:
            augmenter = flow_layer_cuda.fused_augmenter_plain
            layers = flow_layer_cuda.fused_flow_layers_plain
        else:
            augmenter = flow_layer_cuda.fused_augmenter
            layers = flow_layer_cuda.fused_flow_layers
        x, ldj = augmenter(x, eps, context, extra_context, folded_aug)
        x, ldj = layers(x, ldj, context, extra_context, folded)
        return ldj + standard_normal_logprob(x)


def inner_loop(model: FlowCompareModel, batch, *, eps: torch.Tensor):
    """A batch -> (loss, per-point log_prob, nats).

    batch = (extract_0 (B, Nc, >=input_dim), extract_1 (B, N, >=input_dim),
    extra (B, e) or None). Inputs are truncated to input_dim, the extra
    context is repeated over points when the config uses it, and
    nats = -mean(log_prob) * log2(e) / input_dim."""
    c = model.config
    extract_0, extract_1, extra_context = batch
    extract_0 = extract_0[..., :model.input_dim]
    extract_1 = extract_1[..., :model.input_dim]
    if not c["using_extra_context"]:
        extra_context = None
    if extra_context is not None:
        extra_context = extra_context[:, None, :].expand(
            extract_1.shape[0], extract_1.shape[1], extra_context.shape[-1])
    emb = model.embed(extract_0)
    log_prob = model.log_prob(extract_1, emb, extra_context, eps)
    loss = -log_prob.mean()
    nats = loss * LOG2E / c["input_dim"]
    return loss, log_prob, nats
