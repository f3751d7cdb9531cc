"""The port's GEMM routes and the chains' padded layout, on the CPU.

`_build.gemm` / `_build.gemm_tn` send a product to the TMA + wgmma kernels
when TMA can read both operands (a 16-byte-aligned base and rows of whole
16 bytes) and to the WMMA kernels otherwise; the choice is a pure function
of pointers and strides, tested here. The B1, B2, B5 and B7 chains pad
their bf16 buffers and weight copies so that every product qualifies: the
packed coupling-input rows [x1 | extra | pad | cond] start the cond columns
at a multiple of 8 and meet zero rows of the first weight there, which
changes no value. The chains run here with every launch emulated in
PyTorch (the kernels exist only on the card): each gemm and gemm_tn call
must find its operands TMA-readable, and the chains must agree with their
plain versions at the shipped widths (the plain versions are held against
the JAX package by test_torch_port_{flow,vjp,sample,global}.py).
"""

import math

import pytest
import torch

import flowcompare_tpu_torch as ft
from flowcompare_tpu_torch.flows.coupling import sigmoid_scale
from flowcompare_tpu_torch.ops import _build, flow_layer_cuda as flc, flow_layer_vjp_cuda as fv


# ------------------------------------------------------------ route choice

@pytest.mark.parametrize("a_ptr,lda,b_ptr,ldb,route", [
    (0x7f0000000000, 512, 0x7f0000100000, 512, "wgmma"),
    (0x7f0000000010, 304, 0x7f0000100400, 8, "wgmma"),
    (0x7f0000000000, 300, 0x7f0000100000, 512, "wmma"),    # a row of 600 bytes
    (0x7f0000000000, 512, 0x7f0000100000, 6, "wmma"),      # the 6-wide cloud
    (0x7f0000000002, 512, 0x7f0000100000, 512, "wmma"),    # a base 2 bytes off
    (0x7f0000000000, 512, 0x7f0000100008, 512, "wmma"),    # a base 8 bytes off
])
def test_gemm_route_is_decided_by_alignment_alone(a_ptr, lda, b_ptr, ldb, route):
    assert _build.gemm_route(a_ptr, lda, b_ptr, ldb) == route


def test_padded_views_are_tma_readable_and_plain_ones_are_not():
    w = torch.randn(4, 512, 300)
    padded = flc._pad_cols(w.to(torch.bfloat16))
    assert padded.shape == w.shape and torch.equal(padded.float(), w.to(torch.bfloat16).float())
    for l in range(4):
        assert _build.tma_readable(padded[l].data_ptr(), padded[l].stride(0))
        assert padded[l].stride(1) == 1
    plain = w.to(torch.bfloat16).contiguous()
    assert not _build.tma_readable(plain[1].data_ptr(), plain[1].stride(0))
    rows = flc.bf16_rows(100, 300, "cpu")
    assert rows.shape == (100, 300) and _build.tma_readable(rows.data_ptr(), rows.stride(0))
    view = torch.empty(10, 16, dtype=torch.bfloat16)[:, 1:7]
    assert not _build.tma_readable(view.data_ptr(), view.stride(0))


@pytest.mark.parametrize("m,n,tile", [(40960, 512, (128, 128)), (51200, 300, (128, 128)),
                                      (40960, 64, (128, 64)), (50000, 128, (128, 128)),
                                      (4000, 512, (64, 128)), (4000, 64, (64, 64)),
                                      (2500, 64, (64, 64))])
def test_gemm_tile_fills_the_sms(m, n, tile):
    assert _build.gemm_tile(m, n) == tile


@pytest.mark.parametrize("m,n,k", [(512, 512, 20480), (300, 300, 20480), (151, 512, 20480),
                                   (64, 512, 25600), (124, 512, 25600), (64, 128, 25000),
                                   (6, 64, 100), (512, 512, 1000)])
def test_gemm_tn_plan_splits_k_in_whole_stages(m, n, k):
    bn, splits, k_chunk = _build.gemm_tn_plan(m, n, k)
    tiles = math.ceil(m / 128) * math.ceil(n / bn)
    assert bn == (64 if n <= 64 else 128)
    assert k_chunk % 64 == 0 and (splits - 1) * k_chunk < k <= splits * k_chunk
    if splits > 1:      # about one wave of blocks, every split at least 512 rows deep
        assert tiles * splits <= _build.NUM_SMS and k_chunk >= 512
    assert _build.gemm_tn_workspace(m, n, k) >= (splits * m * n if splits > 1 else 0)


def test_gemm_plain_applies_the_epilogue_in_order():
    """The plain version's epilogue, element by element in float64:
    + bias, + residual, + the current output, the leaky affine, pre_out,
    GELU, then x GELU'(aux); a bf16 copy into out2."""
    g = torch.Generator().manual_seed(0)
    a, w = torch.randn(9, 16, generator=g).bfloat16(), torch.randn(16, 12, generator=g).bfloat16()
    bias, res = torch.randn(12, generator=g), torch.randn(9, 12, generator=g)
    aff = (torch.randn(12, generator=g), torch.randn(12, generator=g))
    out0 = torch.randn(9, 12, generator=g)
    v = a.double() @ w.double() + bias.double()
    v = res.double() + v
    v = v + out0.double()
    v = v * aff[0].double() + aff[1].double()
    v = torch.where(v >= 0, v, 0.2 * v)
    pre = v.clone()
    v = 0.5 * v * (1 + torch.erf(v / math.sqrt(2)))
    out, pre_out, out2 = out0.clone(), torch.zeros(9, 12), torch.zeros(9, 12, dtype=torch.bfloat16)
    _build.gemm_plain(a, w, out, bias=bias, residual=res, accumulate=True, affine=aff,
                      pre_out=pre_out, gelu=True, out2=out2)
    torch.testing.assert_close(pre_out.double(), pre, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.double(), v, rtol=1e-5, atol=1e-5)
    assert torch.equal(out2, out.bfloat16())
    grad_in = torch.randn(9, 12, generator=g)
    dv = a.double() @ w.double()
    x = grad_in.double()
    dv = dv * (0.5 * (1 + torch.erf(x / math.sqrt(2))) + x * torch.exp(-0.5 * x * x)
               / math.sqrt(2 * math.pi))
    got = _build.gemm_plain(a, w, torch.empty(9, 12), gelu_grad=grad_in)
    torch.testing.assert_close(got.double(), dv, rtol=1e-5, atol=1e-5)
    bt = torch.randn(12, 16, generator=g).bfloat16()
    torch.testing.assert_close(_build.gemm_plain(a, bt, torch.empty(9, 12), trans_b=True),
                               a.float() @ bt.float().T)
    torch.testing.assert_close(_build.gemm_tn_plain(a, a, torch.empty(16, 16)),
                               a.float().T @ a.float())


# ------------------------------------------------------ the padded layout

# (split, extra width, cond width) of the packed coupling-input rows: the
# flow layers of dulcet-universe / good-surf, of summer-terrain /
# swept-energy (no extra context), of helpful-sponge (the 124-wide
# broadcast embedding), the augmenters (x is 6 wide), and the CPU tests'
# tiny models
PACKED_WIDTHS = [(150, 1, 64), (150, 0, 64), (150, 0, 124), (6, 1, 64), (6, 0, 64), (6, 0, 124),
                 (16, 1, 64), (16, 0, 20)]


@pytest.mark.parametrize("split,extra,cond", PACKED_WIDTHS)
def test_packed_input_layout_starts_cond_on_16_bytes(split, extra, cond):
    xe, xc, width = flc.packed_input_layout(split, extra, cond)
    assert xe == split + extra and xc % 8 == 0 and 0 <= xc - xe < 8
    assert width % 8 == 0 and width >= xc + cond
    xin = torch.empty(32, width, dtype=torch.bfloat16)
    for view in (xin[:, :split], xin[:, :xe], xin[:, xc:xc + cond], xin[:, :xc + cond]):
        assert _build.tma_readable(view.data_ptr(), view.stride(0))


@pytest.mark.parametrize("split,extra,cond", PACKED_WIDTHS)
def test_padded_product_equals_the_unpadded_one(split, extra, cond):
    """[x1 | extra | pad | cond] @ w_in (zero rows at the pad) equals
    [x1 | extra | cond] @ [cpl_in_xe; cpl_in_c] in f32."""
    g = torch.Generator().manual_seed(split + extra + cond)
    layers, hidden, rows = 3, 40, 50
    cpl_in_xe = torch.randn(layers, split + extra, hidden, generator=g)
    cpl_in_c = torch.randn(layers, cond, hidden, generator=g)
    x = torch.randn(rows, split + extra, generator=g)
    c = torch.randn(rows, cond, generator=g)
    xe, xc, width = flc.packed_input_layout(split, extra, cond)
    xin = torch.full((rows, width), float("nan"))
    xin[:, :xe], xin[:, xe:xc], xin[:, xc:xc + cond] = x, 0.0, c
    w_in = flc.packed_input_weights(cpl_in_xe, cpl_in_c)
    assert w_in.shape == (layers, xc + cond, hidden)
    assert torch.count_nonzero(w_in[:, xe:xc]) == 0
    for l in range(layers):
        torch.testing.assert_close(xin[:, :xc + cond] @ w_in[l],
                                   torch.cat([x, c], 1) @ torch.cat([cpl_in_xe[l], cpl_in_c[l]]))


# ------------------------------------- the chains with emulated launches

class EmulatedLaunches:
    """PyTorch stand-ins for every `_build` launch the B1, B2, B5 and B7
    chains make, computing what the kernels compute; gemm and gemm_tn record
    the route their operands would take."""

    FUSED = ("conditioner", "coupling_layer", "coupling_inverse", "conditioner_record",
             "coupling_record", "coupling_bwd", "conditioner_bwd", "gemm_tn_grouped",
             "grad_reduce")

    def __init__(self):
        self.routes = []
        self.fused = []
        self.attention = []
        self.attention_routes = []
        self._originals = {name: getattr(_build, name) for name in self.FUSED}

    def _fused(self, name, xin, *args, **kw):
        """A fused layer launch: the packed rows must be TMA-readable; its
        plain version runs (the wrapper's CPU path)."""
        assert _build.tma_readable(xin.data_ptr(), xin.stride(0))
        self.fused.append(name)
        self._originals[name](xin, *args, **kw)

    def conditioner(self, xin, *args, **kw):
        self._fused("conditioner", xin, *args, **kw)

    def coupling_layer(self, xin, *args, **kw):
        self._fused("coupling_layer", xin, *args, **kw)

    def coupling_inverse(self, xin, *args, **kw):
        self._fused("coupling_inverse", xin, *args, **kw)

    def conditioner_record(self, xin, *args, **kw):
        self._fused("conditioner_record", xin, *args, **kw)

    def coupling_record(self, xin, *args, **kw):
        self._fused("coupling_record", xin, *args, **kw)

    def _launch(self, name, *args, **kw):
        """B5's fused backward and gradient launches: their wrappers' CPU
        path (the plain versions)."""
        self.fused.append(name)
        self._originals[name](*args, **kw)

    def coupling_bwd(self, *args, **kw):
        self._launch("coupling_bwd", *args, **kw)

    def conditioner_bwd(self, *args, **kw):
        self._launch("conditioner_bwd", *args, **kw)

    def gemm_tn_grouped(self, group):
        self._launch("gemm_tn_grouped", group)

    def grad_reduce(self, sums, l):
        self._launch("grad_reduce", sums, l)

    def gemm(self, a, w, out, **kw):
        self.routes.append(_build.gemm_route(a.data_ptr(), a.stride(0), w.data_ptr(),
                                             w.stride(0)))
        return _build.gemm_plain(a, w, out, **kw)

    def gemm_tn(self, a, b, out, ws=None):
        self.routes.append(_build.gemm_route(a.data_ptr(), a.stride(0), b.data_ptr(),
                                             b.stride(0)))
        return _build.gemm_tn_plain(a, b, out)

    @staticmethod
    def cast_rows(src, dst):
        dst.copy_(src)

    @staticmethod
    def row_norm(x, out, eps=1e-5):
        mean = x.mean(-1, keepdim=True)
        out.copy_((x - mean) * torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + eps))

    def _attention_route(self, reads):
        """An attention launch's head width and the route its operands would
        take."""
        self.attention_routes.append((reads[0].shape[1], _build.attention_route(reads)))

    def cross_attention(self, q, k, v, out, *, n_items, m_out=None, den_out=None):
        self.attention.append("cross_attention")
        self._attention_route([q, k, v])
        _build.cross_attention_plain(q, k, v, out, n_items=n_items, m_out=m_out, den_out=den_out)

    @staticmethod
    def coupling_epilogue(st, x, ldj, y, lu_ldj, *, split, eps_affine):
        half = x.shape[1] - split
        sc = sigmoid_scale(st[:, :half], eps_affine)
        y.copy_(torch.cat([x[:, :split], x[:, split:] * sc + st[:, half:]], 1))
        ldj += torch.log(sc).sum(-1) + lu_ldj[0]

    @staticmethod
    def inverse_coupling_epilogue(st, y, x, *, split, eps_affine):
        half = y.shape[1] - split
        sc = sigmoid_scale(st[:, :half], eps_affine)
        x.copy_(torch.cat([y[:, :split], (y[:, split:] - st[:, half:]) / sc], 1))

    @staticmethod
    def augment_epilogue(st, x, eps, z, ldj):
        aug = eps.shape[1]
        log_std = st[:, aug:]
        z.copy_(torch.cat([x, st[:, :aug] + eps * torch.exp(log_std)], 1))
        ldj.copy_((0.5 * math.log(2 * math.pi) + log_std + 0.5 * eps * eps).sum(-1))

    @staticmethod
    def colsum(src, out, ws=None):
        out.copy_(src.sum(0))

    @staticmethod
    def colsum_workspace(rows, cols):
        return 1

    @staticmethod
    def coupling_epilogue_bwd(st, x, dy, dldj, dst, dst_b, dx, y, *, split, eps_affine):
        half = x.shape[1] - split
        sig = torch.sigmoid(st[:, :half])
        sc = (2 * sig - 1) * (1 - eps_affine) + 1
        xf, dy2 = x.float(), dy[:, split:]
        ds = (dy2 * xf[:, split:] + dldj[:, None] / sc) * 2 * sig * (1 - sig) * (1 - eps_affine)
        dst.copy_(torch.cat([ds, dy2], 1))
        dst_b.copy_(dst)
        dx.copy_(torch.cat([dy[:, :split], dy2 * sc], 1))
        y.copy_(torch.cat([xf[:, :split], xf[:, split:] * sc + st[:, half:]], 1))

    def attn_bwd_prep(self, da, a, den, du, ddn):
        self.attention.append("attn_bwd_prep")
        _build.attn_bwd_prep_plain(da, a, den, du, ddn)

    def attention_bwd(self, q, k, v, du, ddn, m, dq, dq_b, dkv, dkv_b, *, n_items):
        self.attention.append("attention_bwd")
        self._attention_route([q, k, v, du])
        _build.attention_bwd_plain(q, k, v, du, ddn, m, dq, dq_b, dkv, dkv_b, n_items=n_items)

    @staticmethod
    def row_norm_bwd(x, g, dx, dx_b, eps=1e-5):
        mean = x.mean(-1, keepdim=True)
        rstd = torch.rsqrt((x * x).mean(-1, keepdim=True) - mean * mean + eps)
        xhat = (x - mean) * rstd
        dx.copy_(rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True)))
        dx_b.copy_(dx)


@pytest.fixture
def emulated(monkeypatch):
    emu = EmulatedLaunches()
    for name in ("gemm", "gemm_tn", "cast_rows", "row_norm", "cross_attention",
                 "coupling_epilogue", "inverse_coupling_epilogue", "augment_epilogue", "colsum",
                 "colsum_workspace", "coupling_epilogue_bwd", "attn_bwd_prep", "attention_bwd",
                 "row_norm_bwd", *EmulatedLaunches.FUSED):
        monkeypatch.setattr(_build, name, getattr(emu, name))
    return emu


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# B5's launches a layer: with attention the conditioner and coupling records,
# ctx @ wkv, the cross attention, the coupling backward, attn_bwd_prep,
# attention_bwd, dctx += dkv wkv^T, the conditioner backward, the grouped
# weight gradients and their sums; without attention the coupling record
# and backward and the two gradient launches
B5_LAUNCHES_PER_LAYER = {"dulcet-universe": 11, "swept-energy": 11, "helpful-sponge": 4}


@pytest.mark.parametrize("preset", ["dulcet-universe", "swept-energy", "helpful-sponge"])
def test_chains_take_the_wgmma_route_at_the_shipped_widths(emulated, preset):
    """B1 (with and without saves), B7, B5 and B2 at the preset's full widths
    (two layers, one item of 32 points): every product finds its operands
    TMA-readable, and each chain agrees with its plain version. B1 and B7
    take the fused layer kernels: per layer one conditioner (with
    attention) and one coupling_layer / coupling_inverse, and no per-product
    MLP gemm (their only gemms are ctx @ wkv, and B7's top LU inverse)."""
    _check_chains(emulated, preset)


@pytest.mark.parametrize("overrides", [{"cross_dim_head": 32}, {"cross_heads": 2},
                                       {"cross_dim_head": 20}, {"cross_heads": 8}],
                         ids=["d32", "d128", "d20", "d512"])
def test_chains_take_the_wgmma_route_at_each_head_width(emulated, overrides):
    """The checks of the shipped widths on dulcet-universe at the attention
    head widths D = 32, 128, 20 and 512: the chains' q, kv halves and
    packed-row columns at those widths give every attention launch the
    wgmma route (at D = 20, v = kv[:, 20:] is read at a column offset)."""
    _check_chains(emulated, "dulcet-universe", **overrides)


def _check_chains(emulated, preset, **overrides):
    cfg = ft.get_config(preset)
    cfg.update(compute_dtype="bfloat16", n_flow_layers=2, sample_size=32, n_samples_context=40,
               **overrides)
    model = ft.FlowCompareModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name.rsplit(".", 1)[-1] in ("lower_entries", "upper_entries", "shift", "log_scale"):
                p.add_(0.01 * torch.randn(p.shape, generator=g))
    ed, lat, e = int(cfg["using_extra_context"]), cfg["latent_dim"], cfg["input_embedding_dim"]
    params = model.params()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # a batched CPU inverse of 300 x 300 matrices can stall on 2 threads
    try:
        folded, folded_inv = model._folded(params, ed), model._folded_inverse(params, ed)
    finally:
        torch.set_num_threads(threads)
    ctx = (torch.randn(1, 1, e, generator=g).bfloat16().expand(1, 32, e) if model.is_global
           else torch.randn(1, 40, e, generator=g).bfloat16())
    extra = torch.randn(1, 32, 1, generator=g) if ed else None
    x, ldj = torch.randn(1, 32, lat, generator=g), torch.zeros(1, 32)
    attn, n_layers = not model.is_global, 2
    cond = ["conditioner"] * n_layers if attn else []

    def launches(fn, *args):
        routes, fused = len(emulated.routes), len(emulated.fused)
        out = fn(*args)
        return out, len(emulated.routes) - routes, sorted(emulated.fused[fused:])

    with torch.no_grad():
        (z, l), gemms, fused = launches(flc._forward_chain, x, ldj, ctx, extra, folded, 1e-8,
                                        False)
        assert gemms == n_layers * attn and fused == sorted(cond + ["coupling_layer"] * n_layers)
        zr, lr = flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded)
        assert float((z - zr).abs().max()) <= 0.05 and float((l - lr).abs().max()) <= 0.01
        xi, gemms, fused = launches(flc._inverse_chain, 0.6 * x, ctx, extra, folded_inv, 1e-8)
        assert gemms == n_layers * attn + 1
        assert fused == sorted(cond + ["coupling_inverse"] * n_layers)
        assert float((xi - flc.fused_flow_layers_inverse_plain(0.6 * x, ctx, extra, folded_inv))
                     .abs().max()) <= 0.05
        (_, _, saves), gemms, fused = launches(flc._forward_chain, x, ldj, ctx, extra, folded,
                                               1e-8, True)
        assert gemms == n_layers * attn and fused.count("coupling_layer") == n_layers
        torch.testing.assert_close(
            saves.float(), flc.fused_flow_layers_plain(x, ldj, ctx, extra, folded,
                                                       save=True)[2].float(), rtol=0, atol=0.05)
        dz, dl = torch.randn(1, 32, lat, generator=g), torch.randn(1, 32, generator=g)
        attention = len(emulated.attention)
        got, gemms, fused = launches(fv._bwd_fused, saves, dz, dl, ctx, extra, folded, 1e-8)
        attention = len(emulated.attention) - attention
        # B5 per layer: the fused kernels, no per-product MLP gemm (its only
        # gemms are ctx @ wkv and dctx += dkv wkv^T) and no colsum
        assert gemms == 2 * n_layers * attn
        assert gemms + len(fused) + attention == n_layers * B5_LAUNCHES_PER_LAYER[preset]
        assert fused == sorted(["coupling_record", "coupling_bwd", "gemm_tn_grouped",
                                "grad_reduce"] * n_layers
                               + ["conditioner_record", "conditioner_bwd"] * n_layers * attn)
        ref = fv.flow_layers_bwd_plain(saves, dz, dl, ctx, extra, folded)
        assert max(_rel(a, b) for a, b in zip(got[:3], ref[:3]) if b is not None) <= 0.03
        assert max(_rel(got[3][k], ref[3][k]) for k in ref[3]) <= 0.05
        folded_aug = flc.fold_augmenter(params["augmenter"], input_dim=6, extra_dim=ed)
        xa, eps = torch.randn(1, 32, 6, generator=g), torch.randn(1, 32, lat - 6, generator=g)
        chain = flc._CouplingChain(folded_aug, ctx, extra, 32, 6)
        _build.cast_rows(xa.reshape(32, 6), chain.xin[:, :6])
        _, gemms, fused = launches(chain.run, 0)
        # B2: the fused conditioner, then ctx @ wkv and the net's four products
        assert gemms == 5 and fused == ["conditioner"]
        za, la = torch.empty(32, lat), torch.empty(32)
        _build.augment_epilogue(chain.st, xa.reshape(32, 6), eps.reshape(32, -1), za, la)
        zr2, lr2 = flc.fused_augmenter_plain(xa, eps, ctx, extra, folded_aug)
        assert float((za.reshape(1, 32, -1) - zr2).abs().max()) <= 0.02
        assert float(((la.reshape(1, 32) - lr2).abs() / lr2.abs().clamp_min(1.0)).max()) <= 1e-4
    assert set(emulated.routes) == {"wgmma"}
    d = cfg["cross_heads"] * cfg["cross_dim_head"]
    assert 1 <= d <= _build.ATTENTION_MAX_D
    assert emulated.attention_routes and set(emulated.attention_routes) == {(d, "wgmma")}
