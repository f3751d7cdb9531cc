"""The conditional flow model: embed, log_prob, sample, data_dependent_init,
inner_loop and make_sample.

Counterpart of `flowcompare_tpu/model.py` (`FlowCompareModel.init_params`,
`embed`, `log_prob`, `sample`, `data_dependent_init`, `inner_loop`,
`make_sample`) for the configurations of the five shipped presets: a DGCNN
or PAConv per-point encoder with an attention conditioner in every coupling
(dulcet-universe, swept-energy, good-surf, summer-terrain), or the global
DGCNN (DGCNNembedderGlobal: max ++ mean pooling to one (B, E) embedding per
cloud) whose couplings read that embedding, broadcast over the points, row
by row with no pre-MLP and no attention (helpful-sponge); the
attention-preconditioned conditional augmenter, sigmoid affine couplings
with ActNorm and LinearLU, and a standard normal base.

Parameters live in the module under the JAX package's pytree paths joined
by '.', so `state_dict()` keys are e.g. `layers.block.coupling.nn.in.w`;
layer stacks keep their leading L axis and weights are stored (in, out).
The parameters are trainable; the BatchNorm running statistics are
buffers under `state.`. The model is built on the CPU from the seeded
generator and then moved to its device, so one seed gives the same weights
on either device; the device is the GPU unless the caller asks for the CPU.

Precision follows the config's `compute_dtype`. Under "bfloat16" the path
is the kernels' (B4 encoder, with `head=False` and the pool and head in
torch for the global DGCNN, or PAConv's B8 and B9 at every level, B2
augmenter, B1 layer stack): on CUDA tensors
the port's hand-written kernels, on CPU tensors their plain versions; with
`plain=True` the plain versions run on any device (the reference the
kernels are held against). Under "float32" (the preset default) the path
is the JAX package's float32 one: the gather encoder, the unfolded
augmenter and the float32 folded scan; the PAConv encoder runs B8 and B9
under either policy, as the JAX package does. The eval path runs under
no_grad.

Sampling walks the layers in reverse from a latent z that the caller
passes in (or `make_sample` draws from an explicit generator): under
"bfloat16" the folded inverse stack (B7 on CUDA tensors, its plain version
on CPU tensors or with `plain=True`), under "float32" the JAX package's
unfolded reverse scan (coupling inverse, ActNorm inverse, LinearLU
triangular solves).

Training (`training=True`) follows the JAX package's: the train-mode
encoder (DGCNN: B6 stages on CUDA tensors, the gather formulation on CPU
tensors; PAConv: in f32, B8 for the centres and autograd gathers),
the unfused augmenter (B2 is eval-only) and, under bf16, the trainable
layer stack (B1 with saves and B5 on CUDA tensors, autograd through the
plain bf16 stack on CPU tensors or with `plain=True`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from .configs.presets import derive
from .core.attention import init_cross_attention
from .core.attention import apply_cross_attention
from .core.initializers import matmul_f32
from .core.mlp import apply_mlp, cast_tree, gelu, init_mlp
from .encoders.dgcnn import apply_dgcnn, apply_dgcnn_train, global_head, init_dgcnn
from .encoders.paconv import apply_pointnet2_paconv, init_pointnet2_paconv
from .flows import actnorm, augment, coupling, permuters
from .flows.distributions import normal_sample, standard_normal_logprob
from .ops import dgcnn_cuda, flow_layer_cuda, flow_layer_vjp_cuda

LOG2E = math.log2(math.e)


class ParamTree(nn.Module):
    """A nested dict/list of tensors as registered parameters (or buffers),
    named by their keys, so state_dict keys are the tree's paths. A None
    leaf (PAConv's ScoreNet has no BatchNorm on its last layer) registers
    nothing and comes back as None from `tree()`."""

    def __init__(self, tree, *, buffers: bool = False):
        super().__init__()
        self._is_list = isinstance(tree, list)
        self._keys = [str(k) for k in (range(len(tree)) if self._is_list else tree)]
        items = enumerate(tree) if self._is_list else tree.items()
        for key, value in items:
            key = str(key)
            if value is None:
                continue
            if isinstance(value, torch.Tensor):
                if buffers:
                    self.register_buffer(key, value)
                else:
                    self.register_parameter(key, nn.Parameter(value))
            else:
                self.add_module(key, ParamTree(value, buffers=buffers))

    def tree(self):
        """The nested dict/list of the current tensors, None leaves kept."""
        out = {**dict(self._parameters), **dict(self._buffers)}
        out.update({k: m.tree() for k, m in self._modules.items()})
        if self._is_list:
            return [out.get(k) for k in self._keys]
        return {k: out.get(k) for k in self._keys}


def _tree_stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_tree_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees, 0)


def _tree_index(tree, l: int):
    """Entry l of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, l) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_index(v, l) for v in tree]
    return tree[l]


class FlowCompareModel(nn.Module):
    """The flow and its parameters, initialised from a seeded generator.

    device=None means "cuda" and raises when no CUDA device is present; pass
    device="cpu" to run on the CPU."""

    def __init__(self, config: dict, *, device=None,
                 generator: Optional[torch.Generator] = None, plain: bool = False):
        super().__init__()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("FlowCompareModel runs on the GPU unless asked otherwise, and "
                                   "no CUDA device is present: pass device='cpu'")
            device = "cuda"
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
        if config["input_embedder"] not in ("DGCNNembedder", "DGCNNembedderGlobal", "PAConv"):
            raise NotImplementedError(f"input_embedder={config['input_embedder']!r} is not "
                                      "ported yet (needs 'DGCNNembedder', "
                                      "'DGCNNembedderGlobal' or 'PAConv')")
        self.is_global = bool(config["global"])
        unsupported = {
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
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -------------------------------------------------------------- init

    def _init_attn(self, gen):
        c = self.config
        return init_cross_attention(
            gen, out_dim=c["attn_dim"], query_dim=c["attn_input_dim"],
            context_dim=c["input_embedding_dim"], heads=c["cross_heads"],
            dim_head=c["cross_dim_head"])

    def _init_block(self, gen):
        c = self.config
        if self.is_global:
            ctx = c["input_embedding_dim"] + c["extra_context_dim"]
            return {"coupling": coupling.init_affine_coupling(gen, self.latent_dim,
                                                              c["hidden_dims"], context_dim=ctx)}
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
        if c["input_embedder"] == "PAConv":
            emb, emb_state = init_pointnet2_paconv(gen, c=self.input_dim - 3,
                                                   k=c["input_embedding_dim"],
                                                   out_mlp_dims=c["hidden_dims_embedder_out"])
        else:
            emb, emb_state = init_dgcnn(gen, input_dim=self.input_dim,
                                        emb_dim=c["input_embedding_dim"],
                                        out_mlp_dims=c["hidden_dims_embedder_out"],
                                        global_pool=self.is_global)
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

    def embed(self, extract_0: torch.Tensor, *, training: bool = False):
        """extract_0 (B, Nc, input_dim) -> (per-point context (B, Nc, E), or
        the global embedding (B, E), state). In training the state holds the
        new BatchNorm running statistics; in eval it is the current state."""
        c = self.config
        params = self.embedder.tree()
        state = self.state.tree()["embedder"]
        if c["input_embedder"] == "PAConv":
            # eval at the compute dtype, training in f32, as the JAX package
            if training:
                emb, new_state = apply_pointnet2_paconv(params, state, extract_0, training=True,
                                                        plain=self.plain)
                return emb, {"embedder": new_state}
            with torch.no_grad():
                emb, _ = apply_pointnet2_paconv(params, state, extract_0,
                                                dtype=self.compute_dtype, plain=self.plain)
            return emb, {"embedder": state}
        if training:
            emb, new_state = apply_dgcnn_train(params, state, extract_0,
                                               n_neighbors=c["n_neighbors"],
                                               dtype=self.compute_dtype, plain=self.plain,
                                               global_pool=self.is_global)
            return emb, {"embedder": new_state}
        with torch.no_grad():
            if self.compute_dtype is None:
                emb = apply_dgcnn(params, state, extract_0, n_neighbors=c["n_neighbors"],
                                  global_pool=self.is_global)
            else:
                # B4 casts the params itself (the kernels' folds once per
                # weights version, `dgcnn_cuda.encoder_weights`)
                encoder = (dgcnn_cuda.fused_dgcnn_encoder_plain if self.plain
                           else dgcnn_cuda.fused_dgcnn_encoder)
                emb = encoder(extract_0, params, state, k=c["n_neighbors"],
                              head=not self.is_global, cast=self.compute_dtype)
                if self.is_global:
                    # B4's trunk, then the pool and the head in torch, as the
                    # JAX package runs them in XLA
                    emb = global_head({"out_mlp": cast_tree(params["out_mlp"],
                                                            self.compute_dtype)}, emb)
        return emb, {"embedder": state}

    def load_state(self, new_state: dict) -> None:
        """Copy a state tree (new BatchNorm running statistics) into the buffers."""
        def walk(module, tree):
            for key, value in (enumerate(tree) if isinstance(tree, list) else tree.items()):
                if value is None:
                    continue
                if isinstance(value, (dict, list)):
                    walk(getattr(module, str(key)), value)
                else:
                    getattr(module, str(key)).copy_(value)
        with torch.no_grad():
            walk(self.state, new_state)

    def _stacks(self, params: dict) -> dict:
        """The per-layer weight stacks with the final block appended."""
        layers = dict(params["layers"])
        layers["permuter"] = permuters.linear_lu_prepare_stack(
            layers["permuter"], eps=self.config["linear_lu_eps"], dtype=self.compute_dtype)
        return flow_layer_cuda.append_final_block(
            flow_layer_cuda.build_layer_stacks(layers), params["final_block"], self.latent_dim)

    def _folded(self, params: dict, extra_dim: int) -> dict:
        return flow_layer_cuda.fold_stacks(self._stacks(params), split=self.latent_dim // 2,
                                           extra_dim=extra_dim)

    def _folded_inverse(self, params: dict, extra_dim: int) -> dict:
        stacks = self._stacks(params)
        return flow_layer_cuda.fold_stacks_inverse(
            stacks, flow_layer_cuda.fold_stacks(stacks, split=self.latent_dim // 2,
                                                extra_dim=extra_dim))

    def log_prob(self, x: torch.Tensor, context: torch.Tensor,
                 extra_context: Optional[torch.Tensor], eps: torch.Tensor, *,
                 training: bool = False) -> torch.Tensor:
        """Per-point log p(x | context) (B, N). eps (B, N, latent - input) is
        the augmenter's standard-normal noise."""
        if not training:
            with torch.no_grad():
                return self._log_prob_eval(x, context, extra_context, eps)
        params = self.params()
        extra_dim = extra_context.shape[-1] if extra_context is not None else 0
        # B2 is eval-only: training takes the unfused augmenter, as the JAX package does
        x, ldj = augment.augment_attn_forward(params["augmenter"], x, context, extra_context,
                                              eps, nonlin=gelu, dtype=self.compute_dtype)
        folded = self._folded(params, extra_dim)
        if self.compute_dtype is None:
            layers = functools.partial(flow_layer_cuda.folded_scan_core, nonlin=gelu)
        elif self.plain:
            layers = flow_layer_cuda.fused_flow_layers_plain
        else:
            layers = flow_layer_vjp_cuda.fused_flow_layers_trainable
        x, ldj = layers(x, ldj.float(), context, extra_context, folded)
        return ldj + standard_normal_logprob(x)

    def _log_prob_eval(self, x, context, extra_context, eps):
        params = self.params()
        extra_dim = extra_context.shape[-1] if extra_context is not None else 0
        folded = self._folded(params, extra_dim)
        if self.compute_dtype is None:
            x, ldj = augment.augment_attn_forward(params["augmenter"], x, context,
                                                  extra_context, eps, nonlin=gelu)
            x, ldj = flow_layer_cuda.folded_scan_core(x, ldj.float(), context, extra_context,
                                                      folded, nonlin=gelu)
            return ldj + standard_normal_logprob(x)
        # B2's folds and their kernel layout, once per weights version
        folded_aug = flow_layer_cuda.augmenter_weights(
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

    # ------------------------------------------------------------ sample

    @torch.no_grad()
    def sample(self, z: torch.Tensor, context: torch.Tensor,
               extra_context: Optional[torch.Tensor]) -> torch.Tensor:
        """The generative pass: z (B, n, latent) -> x (B, n, input_dim).

        context is the eval encoder's (B, Nc, E) output and extra_context
        (B, n, e) or None. Under bf16 the folded stack runs in reverse (B7,
        or its plain version on CPU tensors or with plain=True); under f32
        the unfolded reverse scan: the final block's inverse, then per layer
        from the last the LinearLU solves, the ActNorm inverse and the
        block's inverse."""
        params = self.params()
        if self.compute_dtype is None:
            x = self._sample_unfolded(params, z, context, extra_context)
        else:
            extra_dim = extra_context.shape[-1] if extra_context is not None else 0
            inverse = (flow_layer_cuda.fused_flow_layers_inverse_plain if self.plain
                       else flow_layer_cuda.fused_flow_layers_inverse)
            x = inverse(z, context, extra_context, self._folded_inverse(params, extra_dim))
        return x[..., :self.input_dim]

    def _sample_unfolded(self, params, z, context, extra_context):
        h = self._block_inv(params["final_block"], z, context, extra_context)
        layers = params["layers"]
        lu = permuters.linear_lu_prepare_inverse_stack(layers["permuter"],
                                                       eps=self.config["linear_lu_eps"])
        for l in reversed(range(self.n_layers - 1)):
            h = permuters.linear_lu_inverse(_tree_index(lu, l), h)
            h = actnorm.actnorm_inverse(_tree_index(layers["actnorm"], l), h)
            h = self._block_inv(_tree_index(layers["block"], l), h, context, extra_context)
        return h

    # ----------------------------------------------- ActNorm data-dep init

    def _block_context(self, p: dict, x: torch.Tensor, context, extra_context):
        """The coupling's context: pre-MLP and cross attention on x1 (or, for
        the global conditioner, the broadcast embedding itself), with the
        extra context in front."""
        dt = self.compute_dtype
        if self.is_global:
            ctx = context
        else:
            mlp_out = apply_mlp(p["pre_attention_mlp"], x[..., :self.latent_dim // 2], gelu,
                                dtype=dt)
            ctx = apply_cross_attention(p["attn"], mlp_out, context, dtype=dt)
        if extra_context is not None:
            ctx = torch.cat((extra_context.to(ctx.dtype), ctx), -1)
        return ctx

    def _block_fwd(self, p: dict, x: torch.Tensor, context, extra_context):
        """One unfolded coupling block forward."""
        ctx = self._block_context(p, x, context, extra_context)
        return coupling.affine_coupling_forward(p["coupling"], x, ctx, nonlin=gelu,
                                                dtype=self.compute_dtype)

    def _block_inv(self, p: dict, y: torch.Tensor, context, extra_context):
        """One unfolded coupling block inverse (y1 = x1 feeds the same context)."""
        ctx = self._block_context(p, y, context, extra_context)
        return coupling.affine_coupling_inverse(p["coupling"], y, ctx, nonlin=gelu,
                                                dtype=self.compute_dtype)

    @torch.no_grad()
    def data_dependent_init(self, x: torch.Tensor, context: torch.Tensor,
                            extra_context: Optional[torch.Tensor], eps: torch.Tensor) -> None:
        """The first-batch ActNorm init, in place: walk the unfolded layers
        (block forward, then each ActNorm's shift and log-scale from the
        activations reaching it, the ActNorm, the LinearLU) from the
        augmented x. context is the eval encoder's output."""
        params = self.params()
        h, _ = augment.augment_attn_forward(params["augmenter"], x, context, extra_context, eps,
                                            nonlin=gelu, dtype=self.compute_dtype)
        layers = params["layers"]
        lu = permuters.linear_lu_prepare_stack(layers["permuter"],
                                               eps=self.config["linear_lu_eps"],
                                               dtype=self.compute_dtype)
        inits = []
        for l in range(self.n_layers - 1):
            h, _ = self._block_fwd(_tree_index(layers["block"], l), h, context, extra_context)
            an = actnorm.actnorm_data_init(h)
            h, _ = actnorm.actnorm_forward(an, h)
            w = lu["w_folded"][l]
            h = matmul_f32(h.to(w.dtype), w.T).to(h.dtype)
            inits.append(an)
        self.layers.actnorm.shift.copy_(torch.stack([a["shift"] for a in inits]))
        self.layers.actnorm.log_scale.copy_(torch.stack([a["log_scale"] for a in inits]))


def broadcast_embedding(emb: torch.Tensor, n_points: int) -> torch.Tensor:
    """A global embedding (B, E) repeated over n_points: (B, n_points, E), a
    view; its gradient sums over the points."""
    return emb[:, None, :].expand(emb.shape[0], n_points, emb.shape[-1])


def inner_loop(model: FlowCompareModel, batch, *, eps: torch.Tensor, training: bool = False):
    """A batch -> (loss, per-point log_prob, nats, new_state).

    batch = (extract_0 (B, Nc, >=input_dim), extract_1 (B, N, >=input_dim),
    extra (B, e) or None). Inputs are truncated to input_dim, the extra
    context (and a global embedding) is repeated over points when the config
    uses it, and
    nats = -mean(log_prob) * log2(e) / input_dim. new_state holds the new
    BatchNorm statistics in training and the current ones in eval."""
    c = model.config
    extract_0, extract_1, extra_context = batch
    extract_0 = extract_0[..., :model.input_dim]
    extract_1 = extract_1[..., :model.input_dim]
    if not c["using_extra_context"]:
        extra_context = None
    if extra_context is not None:
        extra_context = extra_context[:, None, :].expand(
            extract_1.shape[0], extract_1.shape[1], extra_context.shape[-1])
    emb, new_state = model.embed(extract_0, training=training)
    if model.is_global:
        emb = broadcast_embedding(emb, extract_1.shape[1])
    log_prob = model.log_prob(extract_1, emb, extra_context, eps, training=training)
    loss = -log_prob.mean()
    nats = loss * LOG2E / c["input_dim"]
    return loss, log_prob, nats, new_state


def make_sample(model: FlowCompareModel, n_points: int, extract_0: torch.Tensor,
                extra: Optional[torch.Tensor] = None, *, z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sample_std: float = 0.6) -> torch.Tensor:
    """n_points generated points per context cloud -> (B, n_points, input_dim).

    extract_0 (B, Nc, >=input_dim) is embedded by the eval encoder; extra
    (B, e) is repeated over the points when the config uses it. z is the
    latent draw (B, n_points, latent) itself; when it is None, z =
    sample_std * N(0, I) is drawn from `generator` on the model's device."""
    extract_0 = extract_0[..., :model.input_dim]
    b = extract_0.shape[0]
    emb, _ = model.embed(extract_0)
    if not model.config["using_extra_context"]:
        extra = None
    if extra is not None:
        extra = extra[:, None, :].expand(b, n_points, extra.shape[-1])
    if model.is_global:
        emb = broadcast_embedding(emb, n_points)
    if z is None:
        z = normal_sample((b, n_points, model.latent_dim), 0.0, sample_std, generator=generator,
                          device=model.device)
    return model.sample(z, emb, extra)
