"""The conditional flow model: embed, log_prob, sample, data_dependent_init,
inner_loop and make_sample.

Counterpart of `flowcompare_tpu/model.py` (`FlowCompareModel.init_params`,
`embed`, `log_prob`, `sample`, `data_dependent_init`, `inner_loop`,
`make_sample`) for every configuration the JAX model accepts:

* the embedders: the DGCNN per-point encoder (dulcet-universe,
  swept-energy), PAConv (good-surf, summer-terrain), the global DGCNN
  (DGCNNembedderGlobal: max ++ mean pooling to one (B, E) embedding per
  cloud, read by the couplings row by row with no pre-MLP and no
  attention; helpful-sponge) and "idenity" (sic, the reference's key: the
  context cloud itself);
* the augmenters: the attention-preconditioned ConditionalNormal (every
  preset), the ConditionalNormal on x alone, the standard normal, and the
  identity where latent_dim == input_dim;
* the couplings: affine with the sigmoid (every preset) or exp scale,
  matrix-exponential and rational-quadratic spline; the permuters:
  LinearLU (every preset), a random permutation, FullCombiner and
  ExponentialCombiner; ActNorm on or off; CIF blocks where cif_latent_dim >
  latent_dim; the four nonlinearities.

It raises where the JAX model raises: latent_dim < input_dim,
cif_latent_dim < latent_dim, CIF with extra context or with the global
embedder, and unknown names.

Parameters live in the module under the JAX package's pytree paths joined
by '.', so `state_dict()` keys are e.g. `layers.block.coupling.nn.in.w`;
layer stacks keep their leading L axis and weights are stored (in, out).
Floating-point leaves are trainable parameters; the permutations' integer
index vectors and the BatchNorm running statistics (under `state.`) are
buffers. The model is built on the CPU from the seeded generator and then
moved to its device, so one seed gives the same weights on either device;
the device is the GPU unless the caller asks for the CPU.

The route of the layer stack is the JAX package's off the TPU:

* the folded stack (`_can_fold_scan`: affine coupling with the sigmoid
  scale, LinearLU, ActNorm, no CIF, config `folded_scan` not False). Under
  "bfloat16" with GELU it runs the kernels (B4 encoder, with `head=False`
  and the pool and head in torch for the global DGCNN, or PAConv's B8 and
  B9 at every level; B2 augmenter; B1 layer stack, B1 with saves and B5 in
  training, B7 in sampling): on CUDA tensors the port's hand-written
  kernels, on CPU tensors their plain versions, and with `plain=True` the
  plain versions on any device (the reference the kernels are held
  against). B1, B2, B5 and B7 compute GELU only; another nonlinearity
  takes `flow_layer_cuda.folded_scan_core` with it under the compute
  dtype, on either device, and the unfused augmenter. Under "float32" the
  path is the JAX package's float32 one: the gather encoder, the unfused
  augmenter and the float32 folded scan; the PAConv encoder runs B8 and B9
  under either policy, as the JAX package does;
* the unfolded layers otherwise (coupling block, ActNorm, permuter per
  layer, then the final block), in the compute dtype's policy.

`routes` says, per part, whether the kernels can take the config's shapes
(`routes.model_routes`: the attention's head width, the fused kernels'
widths and products, the kNN kernels' k, channels and shared memory). A
part they refuse takes the JAX package's path off the TPU whatever the
policy, and the other parts stay on their kernels: the stack
`folded_scan_core` in eval and training and the unfolded reverse in
sampling, the augmenter the unfused one, the DGCNN its gather formulation
in eval and training, PAConv the plain FPS and grouping.

Sampling walks the layers in reverse from a latent z that the caller
passes in (or `make_sample` draws from an explicit generator): B7 on the
kernels' route, else the JAX package's unfolded reverse (coupling inverse,
ActNorm inverse, permuter inverse). The eval path runs under no_grad.

Noise is an input. The JAX package draws it from keys: `_layer_keys`
splits one key into L + 2 (the augmenter's first, one per layer's CIF
draws, the final block's). Here `noise_shapes(b, n)` gives the shapes:
the augmenter's eps (B, N, latent - input) (B, N, 0 for the identity
augmenter) or, for CIF, {"augment": that, "cif": (L, B, N, cif_latent -
latent)}, entry l the draw of layer l and entry L - 1 the final block's;
`sampling=True` gives the latent z (B, n, latent) or, for CIF, {"z": z,
"cif": (L, B, n, cif_latent - latent)}, the slices' draws.
"""

from __future__ import annotations

import math
from types import MappingProxyType
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from .configs.presets import derive
from .core.attention import apply_cross_attention, init_cross_attention
from .core.mlp import NONLINEARITIES, apply_mlp, cast_tree, init_mlp
from .encoders.dgcnn import apply_dgcnn, apply_dgcnn_train, global_head, init_dgcnn
from .encoders.paconv import apply_pointnet2_paconv, init_pointnet2_paconv
from .flows import actnorm, augment, coupling, permuters, spline
from .flows.distributions import normal_sample, standard_normal_logprob
from .ops import dgcnn_cuda, flow_layer_cuda, flow_layer_vjp_cuda
from .routes import model_routes

LOG2E = math.log2(math.e)


class ParamTree(nn.Module):
    """A nested dict/list of tensors as registered parameters (or buffers),
    named by their keys, so state_dict keys are the tree's paths. Integer
    tensors (a permutation's indices) are always buffers. A None leaf
    (PAConv's ScoreNet has no BatchNorm on its last layer) registers nothing
    and comes back as None from `tree()`."""

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
                if buffers or not value.is_floating_point():
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


def _shape_of(noise):
    if isinstance(noise, dict):
        return {k: tuple(v.shape) for k, v in noise.items()}
    return tuple(noise.shape)


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
        self.nonlin_name = config["coupling_block_nonlinearity"]
        self.nonlin = NONLINEARITIES[self.nonlin_name]
        self.input_dim = config["input_dim"]
        self.latent_dim = config["latent_dim"]
        self.n_layers = config["n_flow_layers"]
        self.use_act_norm = bool(config["act_norm"])
        self.flow_type = config["flow_type"]
        self.permuter_type = config["permuter_type"]
        self.plain = plain
        dtype_name = config.get("compute_dtype", "float32")
        if dtype_name not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got {dtype_name}")
        self.compute_dtype = torch.bfloat16 if dtype_name == "bfloat16" else None
        self.is_global = bool(config["global"])
        if config["latent_dim"] < config["input_dim"]:
            raise ValueError("Latent dim < input dim")
        if config["cif_latent_dim"] < config["latent_dim"]:
            raise ValueError("Augment dim smaller than main latent!")
        # CIF blocks: taken when the per-block latent is wider than the main one
        self.is_cif = config["cif_latent_dim"] > config["latent_dim"]
        if self.is_cif and config["using_extra_context"]:
            raise ValueError("Not implemented extra context with cif")
        if self.is_cif and config["global"]:
            raise ValueError("CIF + global embedding not implemented")
        if config["latent_dim"] == config["input_dim"]:
            self.augmenter_kind = "identity"
        elif config["augmenter_dist"] == "StandardNormal":
            self.augmenter_kind = "standard_normal"
        elif config["augmenter_dist"] == "ConditionalNormal":
            self.augmenter_kind = ("conditional_attn" if config["use_attn_augment"]
                                   else "conditional")
        else:
            raise ValueError(f"Invalid augmenter_dist {config['augmenter_dist']}")

        self._routes = MappingProxyType(model_routes(config))
        # the data-parallel mesh of training (train/mesh.py), None in one
        # process: its BatchNorm and ActNorm statistics span the ranks
        self.mesh = None
        # the names of the parameters a mesh's model axis holds as slices
        # between steps (train/mesh.py `shard_params`, `gathered`)
        self.sharded = ()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        params, state = self._init_params(gen)
        for key, value in params.items():
            self.add_module(key, ParamTree(value))
        self.state = ParamTree(state, buffers=True)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def routes(self) -> MappingProxyType:
        """Read-only {"stack", "augmenter", "encoder"} -> "kernels" or
        "plain: <reason>": whether the kernels can take the config's shapes
        (`routes.model_routes`)."""
        return self._routes

    # -------------------------------------------------------------- init

    def _init_attn(self, gen):
        c = self.config
        return init_cross_attention(
            gen, out_dim=c["attn_dim"], query_dim=c["attn_input_dim"],
            context_dim=c["input_embedding_dim"], heads=c["cross_heads"],
            dim_head=c["cross_dim_head"])

    def _init_coupling(self, gen):
        c = self.config
        ctx = (c["input_embedding_dim"] if self.is_global else c["attn_dim"]) + \
            c["extra_context_dim"]
        if self.flow_type == "AffineCoupling":
            return coupling.init_affine_coupling(gen, self.latent_dim, c["hidden_dims"],
                                                 context_dim=ctx)
        if self.flow_type == "ExponentialCoupling":
            return coupling.init_exponential_coupling(gen, self.latent_dim, c["hidden_dims"],
                                                      context_dim=ctx)
        if self.flow_type == "RationalQuadraticSplineCoupling":
            return spline.init_spline_coupling(gen, self.latent_dim, c["hidden_dims"],
                                               num_bins=c["num_bins_spline"], context_dim=ctx)
        raise ValueError(f"Invalid flow type {self.flow_type}")

    def _init_block(self, gen):
        c = self.config
        if self.is_global:
            return {"coupling": self._init_coupling(gen)}
        block = {
            "pre_attention_mlp": init_mlp(gen, self.latent_dim // 2,
                                          c["pre_attention_mlp_hidden_dims"],
                                          c["attn_input_dim"]),
            "attn": self._init_attn(gen),
            "coupling": self._init_coupling(gen),
        }
        if self.is_cif:
            cif_lat = c["cif_latent_dim"]
            # one ConditionalNormal net shared by the block's augment and slice
            block["cif_net"] = init_mlp(gen, self.latent_dim, c["net_cif_dist_hidden_dims"],
                                        (cif_lat - self.latent_dim) * 2)
            block["affine_cif"] = coupling.init_affine_coupling(
                gen, cif_lat, c["affine_cif_hidden"], split_dim=cif_lat - self.latent_dim)
            block["cif_actnorm"] = actnorm.init_actnorm(cif_lat)
        return block

    def _init_permuter(self, gen):
        d = self.latent_dim
        if self.permuter_type == "LinearLU":
            return permuters.init_linear_lu(d, eps=self.config["linear_lu_eps"])
        if self.permuter_type == "random_permute":
            return permuters.init_permuter(gen, d)
        if self.permuter_type == "FullCombiner":
            return permuters.init_full_combiner(gen, d)
        if self.permuter_type == "ExponentialCombiner":
            return permuters.init_exponential_combiner(gen, d)
        raise ValueError(f"Invalid permuter type: {self.permuter_type}")

    def _init_augmenter(self, gen):
        c = self.config
        aug_out = (self.latent_dim - self.input_dim) * 2
        if self.augmenter_kind in ("identity", "standard_normal"):
            return {}
        if self.augmenter_kind == "conditional_attn":
            return {
                "pre_attn_mlp": init_mlp(gen, self.input_dim, c["hidden_dims"],
                                         c["attn_input_dim"]),
                "attn": self._init_attn(gen),
                "augment": {"net": init_mlp(
                    gen, c["attn_dim"] + self.input_dim + c["extra_context_dim"],
                    c["net_augmenter_dist_hidden_dims"], aug_out)},
            }
        return {"augment": {"net": init_mlp(gen, self.input_dim,
                                            c["net_augmenter_dist_hidden_dims"], aug_out)}}

    def _init_params(self, gen):
        c = self.config
        kind = c["input_embedder"]
        if kind == "PAConv":
            emb, emb_state = init_pointnet2_paconv(gen, c=self.input_dim - 3,
                                                   k=c["input_embedding_dim"],
                                                   out_mlp_dims=c["hidden_dims_embedder_out"])
        elif kind in ("DGCNNembedder", "DGCNNembedderGlobal"):
            emb, emb_state = init_dgcnn(gen, input_dim=self.input_dim,
                                        emb_dim=c["input_embedding_dim"],
                                        out_mlp_dims=c["hidden_dims_embedder_out"],
                                        global_pool=self.is_global)
        elif kind == "idenity":  # sic: the reference's key
            emb, emb_state = {}, {}
        else:
            raise ValueError(f"Invalid input embedder {kind}")
        layers = []
        for _ in range(self.n_layers - 1):
            lp = {"block": self._init_block(gen), "permuter": self._init_permuter(gen)}
            if self.use_act_norm:
                lp["actnorm"] = actnorm.init_actnorm(self.latent_dim)
            layers.append(lp)
        params = {
            "embedder": emb,
            "augmenter": self._init_augmenter(gen),
            "layers": _tree_stack(layers),
            "final_block": self._init_block(gen),
        }
        return params, {"embedder": emb_state}

    def params(self) -> dict:
        """The parameter pytree (nested dicts of the module's tensors)."""
        return {k: getattr(self, k).tree()
                for k in ("embedder", "augmenter", "layers", "final_block")}

    def noise_shapes(self, b: int, n: int, *, sampling: bool = False):
        """The shapes of the standard-normal draws of `log_prob` (the
        augmenter's, and per layer the CIF blocks') or, with sampling=True,
        of `sample` (the latent z, and the CIF slices' draws); see the
        module docstring."""
        first = (b, n, self.latent_dim) if sampling else (b, n, self.latent_dim - self.input_dim)
        if not self.is_cif:
            return first
        return {"z" if sampling else "augment": first,
                "cif": (self.n_layers, b, n, self.config["cif_latent_dim"] - self.latent_dim)}

    def _split_noise(self, noise, b: int, n: int, *, sampling: bool = False):
        """(the augmenter's eps or z, the CIF draws or None), checked against
        `noise_shapes`."""
        want = self.noise_shapes(b, n, sampling=sampling)
        if _shape_of(noise) != want:
            raise ValueError(f"noise of shape {_shape_of(noise)}, expected {want}")
        if not self.is_cif:
            return noise, None
        return noise["z" if sampling else "augment"], noise["cif"]

    # ------------------------------------------------------------- embed

    def embed(self, extract_0: torch.Tensor, *, training: bool = False):
        """extract_0 (B, Nc, input_dim) -> (per-point context (B, Nc, E), or
        the global embedding (B, E), state). In training the state holds the
        new BatchNorm running statistics; in eval it is the current state."""
        c = self.config
        params = self.embedder.tree()
        state = self.state.tree()["embedder"]
        if c["input_embedder"] == "idenity":
            return extract_0, {"embedder": state}
        kernels = self.routes["encoder"] == "kernels"
        if c["input_embedder"] == "PAConv":
            # eval at the compute dtype, training in f32, as the JAX package
            plain = self.plain or not kernels
            if training:
                emb, new_state = apply_pointnet2_paconv(params, state, extract_0, training=True,
                                                        plain=plain, mesh=self.mesh)
                return emb, {"embedder": new_state}
            with torch.no_grad():
                emb, _ = apply_pointnet2_paconv(params, state, extract_0,
                                                dtype=self.compute_dtype, plain=plain)
            return emb, {"embedder": state}
        if training:
            emb, new_state = apply_dgcnn_train(params, state, extract_0,
                                               n_neighbors=c["n_neighbors"],
                                               dtype=self.compute_dtype, plain=self.plain,
                                               kernels=kernels, global_pool=self.is_global,
                                               mesh=self.mesh)
            return emb, {"embedder": new_state}
        with torch.no_grad():
            if self.compute_dtype is None or not kernels:
                # the gather formulation: the float32 policy's, and a
                # refused config's under either
                emb = apply_dgcnn(params, state, extract_0, n_neighbors=c["n_neighbors"],
                                  dtype=self.compute_dtype, global_pool=self.is_global)
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

    # ------------------------------------------------------------ routes

    def _can_fold_scan(self) -> bool:
        """The folded layer stack's graph family (JAX's `_can_fold_scan`):
        affine coupling with the sigmoid scale, LinearLU, ActNorm, no CIF,
        and config `folded_scan` not False."""
        c = self.config
        return (bool(c.get("folded_scan", True)) and not self.is_cif
                and self.flow_type == "AffineCoupling" and c["affine_scale_fn"] == "sigmoid"
                and self.permuter_type == "LinearLU" and self.use_act_norm)

    def _kernel_route(self, part: str = "stack") -> bool:
        """B1, B5 and B7 (part "stack") or B2 ("augmenter"), or their plain
        versions: the folded family under bf16, as JAX's `_can_fuse_layers`
        apart from its TPU test, GELU, the one nonlinearity those kernels
        compute, and shapes the kernels take (`routes`)."""
        return (self._can_fold_scan() and self.compute_dtype == torch.bfloat16
                and self.nonlin_name == "GELU" and self.routes[part] == "kernels")

    # ------------------------------------------------------ folded stacks

    def _prepare_layers(self, layers: dict, *, inverse: bool = False) -> dict:
        """LinearLU's packed vectors as dense stacks, once per call: W = L U
        (in the compute dtype) and its log-det for the forward, L and U for
        the inverse solves. Other permuters are used as they are."""
        if self.permuter_type != "LinearLU":
            return layers
        eps = self.config["linear_lu_eps"]
        if inverse:
            prepared = permuters.linear_lu_prepare_inverse_stack(layers["permuter"], eps=eps)
        else:
            prepared = permuters.linear_lu_prepare_stack(layers["permuter"], eps=eps,
                                                         dtype=self.compute_dtype)
        return {**layers, "permuter": prepared}

    def _stacks(self, params: dict) -> dict:
        """The per-layer weight stacks with the final block appended."""
        return flow_layer_cuda.append_final_block(
            flow_layer_cuda.build_layer_stacks(self._prepare_layers(params["layers"])),
            params["final_block"], self.latent_dim)

    def _folded(self, params: dict, extra_dim: int) -> dict:
        return flow_layer_cuda.fold_stacks(self._stacks(params), split=self.latent_dim // 2,
                                           extra_dim=extra_dim)

    def _folded_inverse(self, params: dict, extra_dim: int) -> dict:
        stacks = self._stacks(params)
        return flow_layer_cuda.fold_stacks_inverse(
            stacks, flow_layer_cuda.fold_stacks(stacks, split=self.latent_dim // 2,
                                                extra_dim=extra_dim))

    # ------------------------------------------------------- transforms

    def _block_context(self, p: dict, x: torch.Tensor, context, extra_context):
        """The coupling's context: pre-MLP and cross attention on x1 (or, for
        the global conditioner, the broadcast embedding itself), with the
        extra context in front at the promoted dtype."""
        dt = self.compute_dtype
        if self.is_global:
            ctx = context
        else:
            mlp_out = apply_mlp(p["pre_attention_mlp"], x[..., :self.latent_dim // 2],
                                self.nonlin, dtype=dt)
            ctx = apply_cross_attention(p["attn"], mlp_out, context, dtype=dt)
        if extra_context is not None:
            ctx = coupling.promoted_input(extra_context, ctx)
        return ctx

    def _coupling_fwd(self, p: dict, x: torch.Tensor, ctx):
        c = self.config
        if self.flow_type == "AffineCoupling":
            return coupling.affine_coupling_forward(p, x, ctx, nonlin=self.nonlin,
                                                    scale_fn_type=c["affine_scale_fn"],
                                                    dtype=self.compute_dtype)
        if self.flow_type == "ExponentialCoupling":
            return coupling.exponential_coupling_forward(p, x, ctx, nonlin=self.nonlin)
        return spline.spline_coupling_forward(p, x, ctx, nonlin=self.nonlin,
                                              num_bins=c["num_bins_spline"])

    def _coupling_inv(self, p: dict, y: torch.Tensor, ctx):
        c = self.config
        if self.flow_type == "AffineCoupling":
            return coupling.affine_coupling_inverse(p, y, ctx, nonlin=self.nonlin,
                                                    scale_fn_type=c["affine_scale_fn"],
                                                    dtype=self.compute_dtype)
        if self.flow_type == "ExponentialCoupling":
            return coupling.exponential_coupling_inverse(p, y, ctx, nonlin=self.nonlin)
        return spline.spline_coupling_inverse(p, y, ctx, nonlin=self.nonlin,
                                              num_bins=c["num_bins_spline"])

    def _block_fwd(self, p: dict, x: torch.Tensor, context, extra_context, eps=None):
        """One unfolded coupling block forward (a CIF block with its draw eps)."""
        if self.is_cif:
            return self._cif_block_fwd(p, x, context, eps)[:2]
        return self._coupling_fwd(p["coupling"], x,
                                  self._block_context(p, x, context, extra_context))

    def _block_inv(self, p: dict, y: torch.Tensor, context, extra_context, eps=None):
        """One unfolded coupling block inverse (y1 = x1 feeds the same context)."""
        if self.is_cif:
            return self._cif_block_inv(p, y, context, eps)
        return self._coupling_inv(p["coupling"], y,
                                  self._block_context(p, y, context, extra_context))

    def _cif_block_fwd(self, p: dict, x: torch.Tensor, context, eps, init_actnorm=False):
        """A CIF block: augment (draw eps) -> reverse -> affine -> ActNorm ->
        reverse -> slice -> the conditioned coupling. With init_actnorm the
        block's ActNorm is the data init of what reaches it, also returned."""
        c = self.config
        clamp = c["clamp_dist"]
        split = c["cif_latent_dim"] - self.latent_dim
        x, ldj = augment.augment_conditional_forward({"net": p["cif_net"]}, x, None, eps,
                                                     nonlin=self.nonlin, clamp=clamp,
                                                     dtype=self.compute_dtype)
        x, l2 = coupling.affine_coupling_forward(p["affine_cif"], x.flip(-1), None,
                                                 nonlin=self.nonlin, scale_fn_type="sigmoid",
                                                 split_dim=split, dtype=self.compute_dtype)
        an = actnorm.actnorm_data_init(x, mesh=self.mesh) if init_actnorm else p["cif_actnorm"]
        x, l3 = actnorm.actnorm_forward(an, x)
        x, l4 = augment.slice_forward({"net": p["cif_net"]}, x.flip(-1), None,
                                      num_keep=self.latent_dim, nonlin=self.nonlin, clamp=clamp)
        x, l5 = self._coupling_fwd(p["coupling"], x, self._block_context(p, x, context, None))
        return x, ldj + l2 + l3 + l4 + l5, an

    def _cif_block_inv(self, p: dict, y: torch.Tensor, context, eps):
        """The CIF block's inverse: the coupling's, then the slice's draw (eps),
        the reversed ActNorm and affine inverses, and the augment's cut."""
        c = self.config
        y = self._coupling_inv(p["coupling"], y, self._block_context(p, y, context, None))
        y = augment.slice_inverse({"net": p["cif_net"]}, y, None, eps, nonlin=self.nonlin,
                                  clamp=c["clamp_dist"])
        y = actnorm.actnorm_inverse(p["cif_actnorm"], y.flip(-1))
        y = coupling.affine_coupling_inverse(p["affine_cif"], y, None, nonlin=self.nonlin,
                                             scale_fn_type="sigmoid",
                                             split_dim=c["cif_latent_dim"] - self.latent_dim,
                                             dtype=self.compute_dtype)
        return y.flip(-1)[..., :self.latent_dim]

    def _permuter_fwd(self, p: dict, x: torch.Tensor):
        t = self.permuter_type
        if t == "LinearLU":
            return permuters.linear_lu_forward(p, x, eps=self.config["linear_lu_eps"])
        if t == "random_permute":
            return permuters.permuter_forward(p, x)
        if t == "FullCombiner":
            return permuters.full_combiner_forward(p, x)
        return permuters.exponential_combiner_forward(p, x)

    def _permuter_inv(self, p: dict, y: torch.Tensor) -> torch.Tensor:
        t = self.permuter_type
        if t == "LinearLU":
            return permuters.linear_lu_inverse(p, y, eps=self.config["linear_lu_eps"])
        if t == "random_permute":
            return permuters.permuter_inverse(p, y)
        if t == "FullCombiner":
            return permuters.full_combiner_inverse(p, y)
        return permuters.exponential_combiner_inverse(p, y)

    def _augment_fwd(self, p: dict, eps: torch.Tensor, x: torch.Tensor, context, extra_context):
        """The unfused augmenter -> ([x, z2], -log q(z2))."""
        kind = self.augmenter_kind
        if kind == "identity":
            return x, torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
        if kind == "standard_normal":
            return augment.augment_standard_normal_forward(x, eps)
        if kind == "conditional_attn":
            return augment.augment_attn_forward(p, x, context, extra_context, eps,
                                                nonlin=self.nonlin, dtype=self.compute_dtype)
        return augment.augment_conditional_forward(p["augment"], x, None, eps,
                                                   nonlin=self.nonlin, use_context=False,
                                                   dtype=self.compute_dtype)

    def _layer_fwd(self, lp: dict, x: torch.Tensor, context, extra_context, eps=None):
        """One unfolded (coupling block, ActNorm?, permuter) step -> (x, ldj)."""
        x, ldj = self._block_fwd(lp["block"], x, context, extra_context, eps)
        if self.use_act_norm:
            x, l2 = actnorm.actnorm_forward(lp["actnorm"], x)
            ldj = ldj + l2
        x, l3 = self._permuter_fwd(lp["permuter"], x)
        return x, ldj + l3

    def _layers_unfolded(self, params: dict, x, ldj, context, extra_context, cif_eps):
        """The unfolded layer stack and the final block, from the augmented x.
        Under autograd each layer is recomputed in the backward (the JAX
        model's remat) instead of keeping its activations: a full-width
        spline layer would keep about 170 kB a point."""
        layers = self._prepare_layers(params["layers"])
        remat = torch.is_grad_enabled()
        for l in range(self.n_layers - 1):
            args = (_tree_index(layers, l), x, context, extra_context,
                    None if cif_eps is None else cif_eps[l])
            if remat:
                x, step = torch.utils.checkpoint.checkpoint(self._layer_fwd, *args,
                                                            use_reentrant=False)
            else:
                x, step = self._layer_fwd(*args)
            ldj = ldj + step
        x, step = self._block_fwd(params["final_block"], x, context, extra_context,
                                  None if cif_eps is None else cif_eps[-1])
        return x, ldj + step

    # ------------------------------------------------------------ log_prob

    def log_prob(self, x: torch.Tensor, context: torch.Tensor,
                 extra_context: Optional[torch.Tensor], eps, *,
                 training: bool = False) -> torch.Tensor:
        """Per-point log p(x | context) (B, N). eps is the noise of
        `noise_shapes(B, N)`: the augmenter's standard-normal draw, and for
        CIF the blocks' draws. training=True keeps every stage
        differentiable (B2 is eval-only: training takes the unfused
        augmenter, as the JAX package does)."""
        if not training:
            with torch.no_grad():
                return self._log_prob(x, context, extra_context, eps, False)
        return self._log_prob(x, context, extra_context, eps, True)

    def _log_prob(self, x, context, extra_context, eps, training: bool):
        params = self.params()
        extra_dim = extra_context.shape[-1] if extra_context is not None else 0
        aug_eps, cif_eps = self._split_noise(eps, x.shape[0], x.shape[1])
        kernels = self._kernel_route()
        if not training and self._kernel_route("augmenter"):
            # B2's folds and their kernel layout, once per weights version
            folded_aug = flow_layer_cuda.augmenter_weights(
                params["augmenter"], input_dim=self.input_dim, extra_dim=extra_dim)
            augmenter = (flow_layer_cuda.fused_augmenter_plain if self.plain
                         else flow_layer_cuda.fused_augmenter)
            x, ldj = augmenter(x, aug_eps, context, extra_context, folded_aug,
                               nonlin=self.nonlin_name)
        else:
            x, ldj = self._augment_fwd(params["augmenter"], aug_eps, x, context, extra_context)
        ldj = ldj.float()
        # the plain stack under autograd recomputes each layer in the
        # backward, as the JAX package's scan does
        remat = torch.is_grad_enabled()
        if kernels:
            folded = self._folded(params, extra_dim)
            if self.plain:
                x, ldj = flow_layer_cuda.fused_flow_layers_plain(
                    x, ldj, context, extra_context, folded, nonlin=self.nonlin_name, remat=remat)
            else:
                layers = (flow_layer_vjp_cuda.fused_flow_layers_trainable if training
                          else flow_layer_cuda.fused_flow_layers)
                x, ldj = layers(x, ldj, context, extra_context, folded, nonlin=self.nonlin_name)
        elif self._can_fold_scan():
            x, ldj = flow_layer_cuda.folded_scan_core(
                x, ldj, context, extra_context, self._folded(params, extra_dim),
                nonlin=self.nonlin, dtype=self.compute_dtype, remat=remat)
        else:
            x, ldj = self._layers_unfolded(params, x, ldj, context, extra_context, cif_eps)
        return ldj + standard_normal_logprob(x)

    # ------------------------------------------------------------ sample

    @torch.no_grad()
    def sample(self, z, context: torch.Tensor,
               extra_context: Optional[torch.Tensor]) -> torch.Tensor:
        """The generative pass: z -> x (B, n, input_dim).

        z is the noise of `noise_shapes(B, n, sampling=True)`: the latent
        (B, n, latent), and for CIF the slices' draws. context is the eval
        encoder's (B, Nc, E) output and extra_context (B, n, e) or None. On
        the kernels' route the folded stack runs in reverse (B7, or its plain
        version on CPU tensors or with plain=True); otherwise the unfolded
        reverse: the final block's inverse, then per layer from the last the
        permuter's inverse, the ActNorm inverse and the block's inverse."""
        params = self.params()
        lat = z["z"] if isinstance(z, dict) else z
        z, cif_eps = self._split_noise(z, lat.shape[0], lat.shape[1], sampling=True)
        if self._kernel_route():
            extra_dim = extra_context.shape[-1] if extra_context is not None else 0
            inverse = (flow_layer_cuda.fused_flow_layers_inverse_plain if self.plain
                       else flow_layer_cuda.fused_flow_layers_inverse)
            x = inverse(z, context, extra_context, self._folded_inverse(params, extra_dim),
                        nonlin=self.nonlin_name)
        else:
            x = self._sample_unfolded(params, z, context, extra_context, cif_eps)
        return x[..., :self.input_dim]

    def _sample_unfolded(self, params, z, context, extra_context, cif_eps=None):
        h = self._block_inv(params["final_block"], z, context, extra_context,
                            None if cif_eps is None else cif_eps[-1])
        layers = self._prepare_layers(params["layers"], inverse=True)
        for l in reversed(range(self.n_layers - 1)):
            lp = _tree_index(layers, l)
            h = self._permuter_inv(lp["permuter"], h)
            if self.use_act_norm:
                h = actnorm.actnorm_inverse(lp["actnorm"], h)
            h = self._block_inv(lp["block"], h, context, extra_context,
                                None if cif_eps is None else cif_eps[l])
        return h

    # ----------------------------------------------- ActNorm data-dep init

    @torch.no_grad()
    def data_dependent_init(self, x: torch.Tensor, context: torch.Tensor,
                            extra_context: Optional[torch.Tensor], eps) -> None:
        """The first-batch ActNorm init, in place: walk the unfolded layers
        from the augmented x (block forward, then each ActNorm's shift and
        log-scale from the activations reaching it, the ActNorm, the
        permuter), the CIF blocks' own ActNorms likewise. context is the
        eval encoder's output, eps the noise of `noise_shapes`. Under
        `self.mesh` each statistic is the global batch's. Does nothing
        without ActNorm or CIF."""
        if not self.use_act_norm and not self.is_cif:
            return
        params = self.params()
        aug_eps, cif_eps = self._split_noise(eps, x.shape[0], x.shape[1])
        h, _ = self._augment_fwd(params["augmenter"], aug_eps, x, context, extra_context)
        layers = self._prepare_layers(params["layers"])
        inits, cif_inits = [], []
        for l in range(self.n_layers - 1):
            lp = _tree_index(layers, l)
            if self.is_cif:
                h, _, cif_an = self._cif_block_fwd(lp["block"], h, context, cif_eps[l],
                                                   init_actnorm=True)
                cif_inits.append(cif_an)
            else:
                h, _ = self._block_fwd(lp["block"], h, context, extra_context)
            if self.use_act_norm:
                an = actnorm.actnorm_data_init(h, mesh=self.mesh)
                h, _ = actnorm.actnorm_forward(an, h)
                inits.append(an)
            h, _ = self._permuter_fwd(lp["permuter"], h)
        for module, new in ((getattr(self.layers, "actnorm", None), inits),
                            (getattr(self.layers.block, "cif_actnorm", None), cif_inits)):
            if new:
                module.shift.copy_(torch.stack([a["shift"] for a in new]))
                module.log_scale.copy_(torch.stack([a["log_scale"] for a in new]))


def broadcast_embedding(emb: torch.Tensor, n_points: int) -> torch.Tensor:
    """A global embedding (B, E) repeated over n_points: (B, n_points, E), a
    view; its gradient sums over the points."""
    return emb[:, None, :].expand(emb.shape[0], n_points, emb.shape[-1])


def inner_loop(model: FlowCompareModel, batch, *, eps, training: bool = False):
    """A batch -> (loss, per-point log_prob, nats, new_state).

    batch = (extract_0 (B, Nc, >=input_dim), extract_1 (B, N, >=input_dim),
    extra (B, e) or None). Inputs are truncated to input_dim, the extra
    context (and a global embedding) is repeated over points when the config
    uses it, and
    nats = -mean(log_prob) * log2(e) / input_dim. eps is the noise of
    `model.noise_shapes(B, N)`. new_state holds the new
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


def draw_noise(shapes, *, generator: Optional[torch.Generator] = None, device=None,
               sample_std: float = 1.0):
    """Standard-normal draws of `FlowCompareModel.noise_shapes`' structure (a
    shape, or a dict of shapes drawn in key order) from `generator` on
    `device`; the sampler's latent (a sampling shape given alone, or "z")
    is scaled by sample_std."""
    if isinstance(shapes, dict):
        return {k: draw_noise(v, generator=generator, device=device,
                              sample_std=sample_std if k == "z" else 1.0)
                for k, v in shapes.items()}
    if sample_std != 1.0:
        return normal_sample(shapes, 0.0, sample_std, generator=generator, device=device)
    return torch.randn(shapes, generator=generator, device=device)


def make_sample(model: FlowCompareModel, n_points: int, extract_0: torch.Tensor,
                extra: Optional[torch.Tensor] = None, *, z=None,
                generator: Optional[torch.Generator] = None,
                sample_std: float = 0.6) -> torch.Tensor:
    """n_points generated points per context cloud -> (B, n_points, input_dim).

    extract_0 (B, Nc, >=input_dim) is embedded by the eval encoder; extra
    (B, e) is repeated over the points when the config uses it. z is the
    noise of `model.noise_shapes(B, n_points, sampling=True)` itself (the
    latent, and for CIF the slices' draws); when it is None it is drawn
    from `generator` on the model's device, the latent as sample_std *
    N(0, I)."""
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
        z = draw_noise(model.noise_shapes(b, n_points, sampling=True), generator=generator,
                       device=model.device, sample_std=sample_std)
    return model.sample(z, emb, extra)
