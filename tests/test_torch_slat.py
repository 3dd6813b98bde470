"""Port parity: the Fresnel v2 models (models/slat.py, weights.slat_params)
against the JAX package's fresnel_tpu/models/slat.py on the CPU, at small
widths (features 64 over 7 x 7 patches, hidden 64, 2 blocks of 4 heads, 2
Gaussians per voxel, 48 voxels, a 16^3 structure grid, hidden 32).

* The converter on each model's real `init` tree: the port module's state
  dict has exactly the converted keys and shapes.
* DirectSLatDecoder in float32 (jitted JAX): every output within 2e-5
  abs, with masked voxels, coords outside the grid (clipped) and
  NaN / inf features (nan_to_num); the gradient of each parameter under
  seeded cotangents within 1e-4 of the leaf's largest JAX value.
* In bf16 (`dtype`): each output within 2 x the larger of JAX's own
  bf16-against-float32 difference and one bf16 ulp of its largest value;
  each gradient leaf within 3 x (at these widths a head's gradient sits
  2.1 x JAX's gap from JAX's bf16, as the port's own bf16 sits from float32:
  bf16 noise, not a bias).  Forward hooks see the stack's Dense layers
  run in bf16 and the heads in float32.
* MLPSLatDecoder and DirectStructurePredictor in float32: outputs and
  gradients as above (the structure predictor resizes only the two patch
  axes, with core/ops.py's `resize_linear`, as jax.image.resize does).
* `occupancy_to_coords` equal to JAX's on grids with ties (saturated
  probabilities of exactly 1.0, exact zeros): `lax.top_k` takes the lower
  flat index first.
* The traps: GELU is the tanh form (the exact erf form moves the outputs
  past the tolerance); the self-attention mask is additive (padded
  queries still produce outputs; padded keys change nothing); the
  cross-attention output is zeroed at masked voxels.
* Dropout: keep masks of the activation's shape drawn from the generator
  at rate 0.1 (keep share within 5 sigma of 0.9), kept values scaled by
  1 / 0.9; the same generator seed gives the same outputs; under
  `use_checkpoint` the outputs and the gradients with respect to
  parameters handed in by `functional_call` (not the module's own)
  equal those without it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict
from torch.func import functional_call

from fresnel_tpu.models import slat as J
from fresnel_tpu_torch.models import slat as T
from fresnel_tpu_torch.weights import slat_params
from test_torch_threads import _few_threads  # noqa: F401

B, N, P, F = 2, 48, 49, 64
KW = dict(feature_dim=F, hidden_dim=64, num_layers=2, num_heads=4,
          num_gaussians_per_voxel=2)
MLP_KW = dict(feature_dim=F, hidden_dim=64, num_gaussians_per_voxel=2)
SP_KW = dict(feature_dim=F, hidden_dim=32, resolution=16)
OUT_TOL, GRAD_RTOL = 2e-5, 1e-4
GAP, GRAD_GAP, BF16_ULP = 2.0, 3.0, 2.0 ** -7


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, P, F)).astype(np.float32)
    feats[0, 3, 5], feats[1, 7, 2], feats[1, 8, 9] = np.nan, np.inf, -np.inf
    coords = np.concatenate([np.zeros((B, N, 1)),
                             rng.integers(-3, 68, (B, N, 3))],
                            -1).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[1, 30:] = False
    return feats, coords, mask


def _flat(params):
    return {k: np.asarray(v) for k, v in
            flatten_dict(params["params"], sep="/").items()}


def _init(jm, *args, **kw):
    kw = {k: jnp.asarray(v) for k, v in kw.items()}
    return jax.jit(lambda *a: jm.init(jax.random.PRNGKey(0), *a, **kw))(
        *map(jnp.asarray, args))


def _port(cls, params, **kw):
    m = cls(**kw)
    m.load_state_dict(slat_params(_flat(params)))
    return m


def _jax_out_grads(jm, params, args, kw, cots):
    """Jitted JAX outputs and the gradient of sum(out * cot)."""
    args = tuple(map(jnp.asarray, args))
    kw = {k: jnp.asarray(v) for k, v in kw.items()}

    def fields(p):
        out = jm.apply(p, *args, **kw)
        return out if isinstance(out, dict) else dict(zip(("occ", "logits"),
                                                          out))

    def loss(p):
        out = fields(p)
        return sum(jnp.sum(out[k].astype(jnp.float32) * c)
                   for k, c in cots.items())

    out = jax.jit(fields)(params)
    grads = slat_params(_flat(jax.jit(jax.grad(loss))(params)))
    return {k: np.asarray(v) for k, v in out.items()}, grads


def _port_out_grads(m, args, kw, cots):
    tens = [torch.from_numpy(a) for a in args]
    out = m(*tens, **{k: torch.from_numpy(v) for k, v in kw.items()})
    if not isinstance(out, dict):
        out = dict(zip(("occ", "logits"), out))
    m.zero_grad()
    sum((out[k].float() * torch.from_numpy(c)).sum()
        for k, c in cots.items()).backward()
    return ({k: v.detach() for k, v in out.items()},
            {k: p.grad for k, p in m.named_parameters()})


def _cots(out, seed=5):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=np.shape(out[k])).astype(np.float32)
            for k in out if np.asarray(out[k]).dtype.kind == "f"}


def _check_f32(jout, jgrads, tout, tgrads):
    for k, want in jout.items():
        got = tout[k].numpy()
        if want.dtype.kind != "f":
            assert np.array_equal(got, want), k
        else:
            assert np.abs(got - want).max() <= OUT_TOL, k
    assert set(tgrads) == set(jgrads)
    for k, want in jgrads.items():
        err = (tgrads[k] - want).abs().max().item()
        assert err <= GRAD_RTOL * want.abs().max().item(), k


@pytest.mark.parametrize("name", ["direct", "mlp", "structure"])
def test_converter_on_init_tree(name):
    feats, coords, mask = _inputs()
    if name == "direct":
        p = _init(J.DirectSLatDecoder(**KW), feats, coords, coord_mask=mask)
        m = T.DirectSLatDecoder(**KW)
    elif name == "mlp":
        p = _init(J.MLPSLatDecoder(**MLP_KW), feats, coords)
        m = T.MLPSLatDecoder(**MLP_KW)
    else:
        p = _init(J.DirectStructurePredictor(**SP_KW), feats)
        m = T.DirectStructurePredictor(**SP_KW)
    sd = slat_params(_flat(p))
    want = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    m.load_state_dict(sd)
    if name == "direct":
        # 0-d leaves stay 0-d.
        assert sd["gaussian_head.scale_factor"].dim() == 0
        assert sd["gaussian_head.position_offset_scale"].dim() == 0


@pytest.fixture(scope="module")
def direct():
    feats, coords, mask = _inputs()
    jm = J.DirectSLatDecoder(**KW)
    params = _init(jm, feats, coords, coord_mask=mask)
    args, kw = (feats, coords), dict(coord_mask=mask)
    jout = jax.jit(lambda p: jm.apply(p, *map(jnp.asarray, args),
                                      coord_mask=jnp.asarray(mask)))(params)
    cots = _cots(jout)
    f32 = _jax_out_grads(jm, params, args, kw, cots)
    bf16 = _jax_out_grads(J.DirectSLatDecoder(**KW, dtype=jnp.bfloat16),
                          params, args, kw, cots)
    return dict(params=params, args=args, kw=kw, cots=cots, f32=f32,
                bf16=bf16)


def test_direct_decoder_f32(direct):
    m = _port(T.DirectSLatDecoder, direct["params"], **KW)
    tout, tgrads = _port_out_grads(m, direct["args"], direct["kw"],
                                   direct["cots"])
    _check_f32(*direct["f32"], tout, tgrads)


def test_occupancy_gating_matches(direct):
    feats, coords = direct["args"]
    mask = direct["kw"]["coord_mask"]
    # A threshold at the probabilities' median, so both sides of it occur.
    logits = direct["f32"][0]["occupancy_logits"]
    thr = float(np.median(1.0 / (1.0 + np.exp(-logits))))
    jm = J.DirectSLatDecoder(**KW, occupancy_threshold=thr)
    jout = jax.jit(lambda p: jm.apply(
        p, *map(jnp.asarray, (feats, coords)), coord_mask=jnp.asarray(mask),
        apply_occupancy_mask=True))(direct["params"])
    m = _port(T.DirectSLatDecoder, direct["params"], **KW,
              occupancy_threshold=thr)
    with torch.no_grad():
        tout = m(torch.from_numpy(feats), torch.from_numpy(coords),
                 coord_mask=torch.from_numpy(mask),
                 apply_occupancy_mask=True)
    for k in ("occupancy_mask", "gaussian_mask", "n_gaussians"):
        assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    assert 0 < int(tout["n_gaussians"].sum()) < B * N * 2


def _dtype_probe(m):
    seen = {}

    def hook(name):
        def fn(_mod, _inp, out):
            seen[name] = out.dtype
        return fn
    hooks = [mod.register_forward_hook(hook(name))
             for name, mod in m.named_modules()
             if isinstance(mod, torch.nn.Linear)]
    return seen, hooks


def test_direct_decoder_bf16(direct):
    m = _port(T.DirectSLatDecoder, direct["params"], **KW,
              dtype=torch.bfloat16)
    seen, hooks = _dtype_probe(m)
    tout, tgrads = _port_out_grads(m, direct["args"], direct["kw"],
                                   direct["cots"])
    for h in hooks:
        h.remove()
    stack = {k: v for k, v in seen.items() if k.startswith(("block_",
                                                            "feature_"))}
    heads = {k: v for k, v in seen.items() if k.startswith((
        "gaussian_head", "OccupancyHead"))}
    assert stack and set(stack.values()) == {torch.bfloat16}
    assert heads and set(heads.values()) == {torch.float32}
    (jf, gf), (jb, gb) = direct["f32"], direct["bf16"]
    for k, want in jb.items():
        if want.dtype.kind != "f":
            continue
        gap = np.abs(want - jf[k]).max()
        ulp = BF16_ULP * np.abs(jf[k]).max()
        err = np.abs(tout[k].float().numpy() - want).max()
        assert err <= GAP * max(gap, ulp), (k, err, gap, ulp)
    for k, want in gb.items():
        scale = gf[k].abs().max().item()
        gap = (want - gf[k]).abs().max().item()
        err = (tgrads[k] - want).abs().max().item()
        assert err <= GRAD_GAP * max(gap, BF16_ULP * scale), (k, err, gap)


def test_mlp_decoder_f32():
    _, coords, _ = _inputs(2)
    feats = np.random.default_rng(2).normal(size=(B, P, F)).astype(
        np.float32)
    jm = J.MLPSLatDecoder(**MLP_KW)
    p = _init(jm, feats, coords)
    jout = jm.apply(p, *map(jnp.asarray, (feats, coords)))
    cots = _cots(jout)
    want = _jax_out_grads(jm, p, (feats, coords), {}, cots)
    m = _port(T.MLPSLatDecoder, p, **MLP_KW)
    _check_f32(*want, *_port_out_grads(m, (feats, coords), {}, cots))


def test_structure_predictor_f32():
    feats = np.random.default_rng(3).normal(size=(B, P, F)).astype(
        np.float32)
    jm = J.DirectStructurePredictor(**SP_KW)
    p = _init(jm, feats)
    jout = dict(zip(("occ", "logits"), jm.apply(p, jnp.asarray(feats))))
    assert jout["occ"].shape == (B, 16, 16, 16)
    cots = _cots(jout)
    want = _jax_out_grads(jm, p, (feats,), {}, cots)
    m = _port(T.DirectStructurePredictor, p, **SP_KW)
    _check_f32(*want, *_port_out_grads(m, (feats,), {}, cots))


def _grid_with_ties(kind, D=8):
    rng = np.random.default_rng(4)
    g = rng.uniform(size=(D, D, D)).astype(np.float32)
    if kind == "saturated":
        g[rng.uniform(size=g.shape) < 0.1] = 1.0     # sigmoid's saturation
    elif kind == "zeros":
        g[rng.uniform(size=g.shape) < 0.9] = 0.0
    elif kind == "quantised":
        g = np.round(g * 4) / 4
    return g


@pytest.mark.parametrize("kind", ["saturated", "zeros", "quantised"])
@pytest.mark.parametrize("max_coords", [20, 100])
def test_occupancy_to_coords_ties(kind, max_coords):
    g = _grid_with_ties(kind)
    jc, jv = J.occupancy_to_coords(jnp.asarray(g), max_coords)
    tc, tv = T.occupancy_to_coords(torch.from_numpy(g), max_coords)
    assert tc.dtype == torch.int32
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_gelu_is_the_tanh_form(direct, monkeypatch):
    import fresnel_tpu_torch.models.slat as slat
    monkeypatch.setattr(slat, "gelu", lambda x: torch.nn.functional.gelu(x))
    m = _port(T.DirectSLatDecoder, direct["params"], **KW)
    with torch.no_grad():
        out = m(*map(torch.from_numpy, direct["args"]),
                coord_mask=torch.from_numpy(direct["kw"]["coord_mask"]))
    assert np.abs(out["gaussians"].numpy()
                  - direct["f32"][0]["gaussians"]).max() > OUT_TOL


def test_attention_masks(direct):
    m = _port(T.DirectSLatDecoder, direct["params"], **KW)
    feats, coords, mask = direct["args"] + (direct["kw"]["coord_mask"],)
    blk = m.block_0
    x = torch.randn(B, N, 64, generator=torch.Generator().manual_seed(0))
    tmask = torch.from_numpy(mask)
    with torch.no_grad():
        sa = blk.SelfAttention_0(x, tmask)
        x2 = x.clone()
        x2[~tmask] = 7.0                         # only padded voxels change
        sa2 = blk.SelfAttention_0(x2, tmask)
        ctx = m.feature_proj(torch.nan_to_num(
            torch.from_numpy(feats), nan=0.0, posinf=1.0, neginf=-1.0))
        ca = blk.CrossAttention_0(x, ctx, tmask)
    # Padded queries produce outputs; padded keys change no valid row.
    assert sa[~tmask].abs().min() > 0
    assert torch.equal(sa[tmask], sa2[tmask])
    assert torch.equal(ca[~tmask], torch.zeros_like(ca[~tmask]))
    assert ca[tmask].abs().max() > 0


def test_dropout_rate_scale_and_generator():
    feats, coords, mask = _inputs()
    m = T.DirectSLatDecoder(**KW)
    from fresnel_tpu_torch.weights import init_flax_like_
    init_flax_like_(m, torch.Generator().manual_seed(0))
    keeps = []
    orig = T.SparseTransformerBlock.forward

    def spy(self, x, context, mask=None, keep=None, rate=0.0):
        keeps.append((keep, rate, x.shape))
        return orig(self, x, context, mask, keep, rate)

    args = (torch.from_numpy(feats), torch.from_numpy(coords))
    kw = dict(coord_mask=torch.from_numpy(mask), deterministic=False)
    T.SparseTransformerBlock.forward = spy
    try:
        with torch.no_grad():
            a = m(*args, **kw, generator=torch.Generator().manual_seed(3))
    finally:
        T.SparseTransformerBlock.forward = orig
    assert len(keeps) == KW["num_layers"]
    for keep, rate, shape in keeps:
        assert keep.dtype == torch.bool and keep.shape == shape
        assert rate == 0.1
        n = keep.numel()
        share = keep.float().mean().item()
        assert abs(share - 0.9) <= 5 * (0.9 * 0.1 / n) ** 0.5
    with torch.no_grad():
        b = m(*args, **kw, generator=torch.Generator().manual_seed(3))
        c = m(*args, **kw, generator=torch.Generator().manual_seed(4))
        d = m(*args, coord_mask=kw["coord_mask"])
    assert torch.equal(a["gaussians"], b["gaussians"])
    assert not torch.equal(a["gaussians"], c["gaussians"])
    assert not torch.equal(a["gaussians"], d["gaussians"])
    # Scale: kept MLP outputs are divided by 1 - rate.
    blk = m.block_0
    ctx = m.feature_proj(torch.nan_to_num(args[0], nan=0.0, posinf=1.0,
                                          neginf=-1.0))
    x = torch.randn(B, N, 64, generator=torch.Generator().manual_seed(1))
    ones = torch.ones(B, N, 64, dtype=torch.bool)
    with torch.no_grad():
        full = blk(x, ctx, kw["coord_mask"])
        none = blk(x, ctx, kw["coord_mask"], ~ones, 0.5)
        kept = blk(x, ctx, kw["coord_mask"], ones, 0.5)
    torch.testing.assert_close(kept - none, (full - none) / 0.5,
                               rtol=1e-5, atol=1e-5)


def test_checkpoint_recomputes_with_the_same_masks_and_weights():
    feats, coords, mask = _inputs()
    m = T.DirectSLatDecoder(**KW)
    from fresnel_tpu_torch.weights import init_flax_like_
    init_flax_like_(m, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(9)
    # Parameters other than the module's own, as the trainer hands them.
    params = {k: (v + 0.01 * torch.randn(v.shape, generator=g)).detach()
              for k, v in m.named_parameters()}
    args = (torch.from_numpy(feats), torch.from_numpy(coords))
    res = []
    for ckpt in (False, True):
        m.use_checkpoint = ckpt
        ps = {k: v.clone().requires_grad_() for k, v in params.items()}
        out = functional_call(m, ps, args, dict(
            coord_mask=torch.from_numpy(mask), deterministic=False,
            generator=torch.Generator().manual_seed(3)))
        loss = out["gaussians"].square().mean() + out[
            "occupancy_logits"].mean()
        grads = torch.autograd.grad(loss, list(ps.values()))
        res.append((out["gaussians"].detach(), grads))
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
