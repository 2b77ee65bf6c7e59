"""The port's RT-DETR-L (``models/rtdetr.py``) vs the JAX package's, on
the CPU in float32.

Both packages load ``assets/rtdetr_l_synthetic_256.npz`` (float16
storage, float32 parameters) once per module; the JAX forward is
compiled once per input shape, with the bf16 gather values off
(``rtdetr._BF16_VALS``, read at import, pinned here as
tests/test_rtdetr.py pins it). Tolerances, each measured well under:

  * single modules on random inputs (convs of every activation and
    grouping, layer norm, attention, the sincos embedding, the anchors,
    the deformable sampling in f32 and with bf16 values, both gather
    formulations): 1e-5 absolute (values of order 1);
  * the backbone's taps and the encoder's maps: 1e-5 of each tensor's
    largest magnitude (float32 summation order through ~70 convs;
    measured ≤ 1e-6);
  * the decoder on the JAX encoder's maps, and the whole forward at
    2 × 128 × 128 with 100 queries: boxes and scores within 1e-5
    (measured ≤ 4e-7), after the encoder's top-100 anchor indices
    are checked equal as sets and in order;
  * a 64 × 64 input, whose 84 anchors clamp the 100 queries, with
    ``decoder_layers`` 2: the same.

Loaders: the float16 ``.npz`` and an ultralytics-layout state dict
(built from the asset's shapes, as tests/test_rtdetr_backend.py builds
one) give trees equal to the JAX import's; the state dict saved as a
``.pt`` loads to the same tree.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roadvision_tpu.models import rtdetr as J
from roadvision_tpu_torch.models import rtdetr as T
from roadvision_tpu_torch.models.yolo import weights as tweights

NPZ = "assets/rtdetr_l_synthetic_256.npz"
TOL = 1e-5
REL = 1e-5


def _frames(h, w, n=2, seed=0):
    """Synthetic road frames as the detector sees them: RGB in [0, 1]."""
    from roadvision_tpu_torch.io_video import SyntheticRoadSource
    src = SyntheticRoadSource(w, h, num_vehicles=5, seed=seed)
    bgr = np.stack([src.render(5 * i) for i in range(n)])
    return np.ascontiguousarray(bgr[..., ::-1]).astype(np.float32) / 255.0


def _jax_run(params, x, nq, decl=None):
    """The JAX forward's intermediates: taps, encoder maps, the top
    class logit per anchor, the top-nq indices (as decoder_forward
    selects them), and the outputs."""
    c3, c4, c5 = J.hgnet_forward(params["backbone"], x)
    feats = J.encoder_forward(params["enc"], c3, c4, c5)
    dec, b = params["dec"], x.shape[0]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    memory = jnp.concatenate(
        [J._conv(f, dec["input_proj"][i], act=None).reshape(b, -1, J.HD)
         for i, f in enumerate(feats)], axis=1)
    _, valid = J._anchors_for(shapes)
    feats_q = J._ln(J._lin(memory * valid[None], dec["enc_output"]["lin"]),
                    dec["enc_output"]["ln"])
    top_val = jnp.max(J._lin(feats_q, dec["enc_score"]), axis=-1)
    _, topk = jax.lax.top_k(top_val, min(nq, memory.shape[1]))
    boxes, scores = J.forward_rtdetr_raw(params, x, nc=80, num_queries=nq,
                                         decoder_layers=decl)
    return (c3, c4, c5), feats, top_val, topk, boxes, scores


@pytest.fixture(scope="module")
def asset():
    """(JAX tree, port tree, port model) of the checked-in checkpoint."""
    jp, jnc, jok = J.load_params_rtdetr(NPZ)
    tp, tnc, tok = T.load_params_rtdetr(NPZ)
    assert jok and tok and jnc == tnc == 80
    return jp, tp, T.model_from_params(tp).eval()


@pytest.fixture(scope="module")
def runs(asset):
    """JAX runs (f32 gather values) on 2 × 128² frames and on 2 × 64²
    frames with two decoder layers."""
    jp = asset[0]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "_BF16_VALS", False)
        for key, (hw, nq, decl) in {"128": (128, 100, None),
                                    "64": (64, 100, 2)}.items():
            x = _frames(hw, hw)
            fn = jax.jit(lambda p, x, nq=nq, decl=decl: _jax_run(p, x, nq,
                                                                decl))
            out[key] = (x, jax.tree.map(np.asarray, fn(jp, jnp.asarray(x))))
    return out


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _close_rel(got, want, rel=REL):
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape
    assert err <= rel * float(np.abs(want).max()) + 1e-6, err


# ---------------------------------------------------------------------------
# loaders

def test_npz_import_equals_jax(asset):
    jp, tp, _ = asset
    jf = tweights.flatten_tree(jax.tree.map(np.asarray, jp))
    tf = tweights.flatten_tree(tp)
    assert sorted(jf) == sorted(tf) and len(tf) == 456
    assert sum(v.size for v in tf.values()) == 32_126_892
    for k, v in tf.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, jf[k], err_msg=k)


def _ultralytics_sd(tree, seed=0):
    """An ultralytics-layout state dict whose shapes mirror ``tree`` (the
    key names of tests/test_rtdetr_backend.py::_synth_sd_from_tree)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def rnd(*shape, scale=0.05, shift=0.0):
        return torch.randn(shape, generator=g) * scale + shift

    def convbn(prefix, w):
        k, cin, cout = w.shape[0], w.shape[2], w.shape[3]
        sd[f"{prefix}.conv.weight"] = rnd(cout, cin, k, k)
        sd[f"{prefix}.bn.weight"] = torch.rand(cout, generator=g) + 0.5
        sd[f"{prefix}.bn.bias"] = rnd(cout, scale=0.1)
        sd[f"{prefix}.bn.running_mean"] = rnd(cout, scale=0.1)
        sd[f"{prefix}.bn.running_var"] = torch.rand(cout, generator=g) + 0.5

    def lin(prefix, p):
        cin, cout = p["w"].shape
        sd[f"{prefix}.weight"] = rnd(cout, cin)
        sd[f"{prefix}.bias"] = rnd(cout, scale=0.1)

    def ln(prefix, p):
        d = p["g"].shape[0]
        sd[f"{prefix}.weight"] = torch.rand(d, generator=g) + 0.5
        sd[f"{prefix}.bias"] = rnd(d, scale=0.1)

    def mha(prefix, p):
        d = p["q"]["w"].shape[0]
        sd[f"{prefix}.in_proj_weight"] = rnd(3 * d, d)
        sd[f"{prefix}.in_proj_bias"] = rnd(3 * d, scale=0.1)
        lin(f"{prefix}.out_proj", p["o"])

    bk = tree["backbone"]
    for name, key in (("s1", "stem1"), ("s2a", "stem2a"), ("s2b", "stem2b"),
                      ("s3", "stem3"), ("s4", "stem4")):
        convbn(f"model.0.{key}", bk["stem"][name]["w"])
    for idx, si, bi in T._SD_HGBLOCKS:
        blk = bk["stages"][si][bi]
        for j, m in enumerate(blk["m"]):
            if T._L_STAGES[si][4]:
                convbn(f"model.{idx}.m.{j}.conv1", m["cv1"]["w"])
                convbn(f"model.{idx}.m.{j}.conv2", m["cv2"]["w"])
            else:
                convbn(f"model.{idx}.m.{j}", m["cv"]["w"])
        convbn(f"model.{idx}.sc", blk["sc"]["w"])
        convbn(f"model.{idx}.ec", blk["ec"]["w"])
    for i, idx in enumerate(("2", "4", "8")):
        convbn(f"model.{idx}", bk["down"][i]["w"])
    enc = tree["enc"]
    for idx, name, _ in T._SD_ENC_CONVS:
        convbn(f"model.{idx}", enc[name]["w"])
    for idx, name in T._SD_REPC3:
        p = enc[name]
        convbn(f"model.{idx}.cv1", p["cv1"]["w"])
        convbn(f"model.{idx}.cv2", p["cv2"]["w"])
        for j, m in enumerate(p["m"]):
            convbn(f"model.{idx}.m.{j}.conv1", m["w"])            # 3×3
            convbn(f"model.{idx}.m.{j}.conv2", np.zeros(          # 1×1
                (1, 1) + tuple(m["w"].shape[2:]), np.float32))
    mha("model.11.ma", enc["aifi"]["mha"])
    for name in ("ln1", "ln2"):
        ln(f"model.11.norm{name[-1]}", enc["aifi"][name])
    lin("model.11.fc1", enc["aifi"]["fc1"])
    lin("model.11.fc2", enc["aifi"]["fc2"])
    dec, d = tree["dec"], "model.28"
    for lv, p in enumerate(dec["input_proj"]):
        cout = p["w"].shape[3]
        sd[f"{d}.input_proj.{lv}.0.weight"] = rnd(cout, p["w"].shape[2], 1, 1)
        sd[f"{d}.input_proj.{lv}.1.weight"] = torch.rand(cout, generator=g) + .5
        sd[f"{d}.input_proj.{lv}.1.bias"] = rnd(cout, scale=0.1)
        sd[f"{d}.input_proj.{lv}.1.running_mean"] = rnd(cout, scale=0.1)
        sd[f"{d}.input_proj.{lv}.1.running_var"] = \
            torch.rand(cout, generator=g) + 0.5
    for i, lp in enumerate(dec["layers"]):
        li = f"{d}.decoder.layers.{i}"
        mha(f"{li}.self_attn", lp["sa"])
        for tname, ours in (("sampling_offsets", "off"),
                            ("attention_weights", "attw"),
                            ("value_proj", "val"), ("output_proj", "out")):
            lin(f"{li}.cross_attn.{tname}", lp["ca"][ours])
        for j in (1, 2, 3):
            ln(f"{li}.norm{j}", lp[f"ln{j}"])
        lin(f"{li}.linear1", lp["ffn1"])
        lin(f"{li}.linear2", lp["ffn2"])
    lin(f"{d}.enc_output.0", dec["enc_output"]["lin"])
    ln(f"{d}.enc_output.1", dec["enc_output"]["ln"])
    lin(f"{d}.enc_score_head", dec["enc_score"])
    for j, p in enumerate(dec["enc_bbox"]):
        lin(f"{d}.enc_bbox_head.layers.{j}", p)
    for i in range(T.NDL):
        lin(f"{d}.dec_score_head.{i}", dec["dec_score"][i])
        for j, p in enumerate(dec["dec_bbox"][i]):
            lin(f"{d}.dec_bbox_head.{i}.layers.{j}", p)
    for j, p in enumerate(dec["qpos"]):
        lin(f"{d}.query_pos_head.layers.{j}", p)
    sd["model.28.denoising_class_embed.weight"] = rnd(81, 256)  # ignored
    return sd


def _assert_trees_equal(tree, jtree):
    jf = tweights.flatten_tree(jax.tree.map(np.asarray, jtree))
    tf = tweights.flatten_tree(tree)
    assert sorted(jf) == sorted(tf)
    for k, v in tf.items():
        np.testing.assert_array_equal(v, jf[k], err_msg=k)


def test_state_dict_import_equals_jax(asset, tmp_path):
    """An ultralytics-layout state dict: the port's tree equals the JAX
    import's (BN and RepConv branches fused in float64 alike); saved as a
    ``.pt`` it loads to the same tree."""
    sd = _ultralytics_sd(asset[1])
    tree = T.state_dict_to_params_rtdetr(sd)
    _assert_trees_equal(tree, J.state_dict_to_params_rtdetr(sd))
    shapes = jax.tree.map(np.shape, tree)
    assert shapes == jax.tree.map(np.shape, asset[1])
    pt = tmp_path / "rtdetr-l.pt"
    torch.save(sd, pt)
    got, nc, ok = T.load_params_rtdetr(str(pt))
    assert ok and nc == 80
    _assert_trees_equal(got, tree)


def test_repc3_fused_form_and_empty_guard():
    """A fuse()-saved RepC3 (one conv + bias) imports; a block-less one
    is refused, as the JAX importer refuses it."""
    g = torch.Generator().manual_seed(5)
    sd = {f"r.{cv}.conv.{leaf}": torch.randn(shape, generator=g)
          for cv in ("cv1", "cv2")
          for leaf, shape in (("weight", (4, 4, 1, 1)), ("bias", (4,)))}
    sd["r.m.0.conv.weight"] = torch.randn(4, 4, 3, 3, generator=g)
    sd["r.m.0.conv.bias"] = torch.randn(4, generator=g)
    got, want = T._repc3_t(sd, "r"), J._repc3_t(sd, "r")
    _assert_trees_equal(got, want)
    for k in ("r.m.0.conv.weight", "r.m.0.conv.bias"):
        del sd[k]
    with pytest.raises(KeyError):
        T._repc3_t(sd, "r")


def test_renamed_npz_is_sniffed_and_foreign_pytree_degrades(tmp_path):
    renamed = tmp_path / "mystery.npz"
    renamed.write_bytes(open(NPZ, "rb").read())
    assert T.is_rtdetr_npz(renamed) and J.is_rtdetr_npz(renamed)
    yolo = "assets/yolov8n_synthetic_256.npz"
    assert not T.is_rtdetr_npz(yolo) and not J.is_rtdetr_npz(yolo)
    assert not T.is_rtdetr_npz(tmp_path / "absent.npz")
    # a YOLO pytree in an rtdetr-named file: random init, as in JAX
    foreign = tmp_path / "rtdetr-yolo.npz"
    foreign.write_bytes(open(yolo, "rb").read())
    tree, nc, loaded = T.load_params_rtdetr(str(foreign), nc=7)
    assert not loaded and nc == 7 and T.nc_of(tree) == 7


def test_seeded_init_has_the_jax_structure(asset):
    """``random_model`` follows ``init_params_rtdetr``: the tree's layout
    and shapes, the offset bias, the score prior, the zeroed heads."""
    a = T.random_model(80, seed=3)
    tree = T.tree_from_model(a)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, asset[1])
    dec = tree["dec"]
    np.testing.assert_allclose(dec["layers"][0]["ca"]["off"]["b"],
                               np.asarray(J._deform_offset_init()), atol=1e-6)
    assert not dec["layers"][0]["ca"]["attw"]["w"].any()
    assert not dec["enc_bbox"][2]["w"].any()
    np.testing.assert_allclose(dec["enc_score"]["b"], -np.log(99.0),
                               rtol=1e-6)
    conv = tree["backbone"]["stem"]["s1"]["w"]             # He-normal
    assert abs(conv.std() / np.sqrt(2.0 / 27) - 1) < 0.2
    # the weights module's tree ↔ module mapping takes RT-DETR too
    model = tweights.model_from_params(tree)
    assert isinstance(model, T.RTDETR)
    _assert_trees_equal(tweights.tree_from_model(model), tree)
    assert tweights.params_from_jax(tree).keys() == a.state_dict().keys()


# ---------------------------------------------------------------------------
# single modules

def _conv_pair(rng, cin, cout, k, stride, groups, pad, act):
    w = (rng.randn(k, k, cin // groups, cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    conv = T.Conv(cin, cout, k, stride, act=act, groups=groups, pad=pad)
    conv.load_state_dict({"weight": torch.from_numpy(
        w.transpose(3, 2, 0, 1).copy()), "bias": torch.from_numpy(b)})
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, conv


@pytest.mark.parametrize("cin,cout,k,stride,groups,pad,act", [
    (3, 32, 3, 2, 1, None, "relu"),     # the stem
    (32, 16, 2, 1, 1, 0, "relu"),       # stem2a, pad 0
    (48, 48, 5, 1, 48, None, "relu"),   # a light block's depthwise conv
    (64, 64, 3, 2, 64, None, None),     # a downsample: depthwise, f32 out
    (64, 32, 1, 1, 1, None, "silu"),    # the encoder's laterals
    (32, 32, 3, 1, 1, None, "gelu"),
])
def test_conv_matches_jax(cin, cout, k, stride, groups, pad, act):
    rng = np.random.RandomState(cin + k)
    jp, conv = _conv_pair(rng, cin, cout, k, stride, groups, pad, act)
    x = rng.rand(2, 13, 17, cin).astype(np.float32)
    want = np.asarray(J._conv(jnp.asarray(x), jp, stride=stride, act=act,
                              pad=pad))
    with torch.no_grad():
        got = _nhwc(conv(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_quantized_conv_activations_match_conv_i8(act):
    """``QConv`` with each of ``conv_i8``'s activations: bit-equal without
    one; ReLU and SiLU within 4 float32 ulps (evaluated in f64 and
    rounded once, where JAX evaluates in f32); GELU within 1e-6 (outputs
    of order 1): JAX's f32 0.5·x·(1 + tanh z) cancels for negative x, by
    tens of ulps of the small results there."""
    from roadvision_tpu.models.yolo import quant as jq
    from roadvision_tpu_torch.models.yolo import quant as tq
    rng = np.random.RandomState(11)
    jp, conv = _conv_pair(rng, 48, 32, 3, 1, 1, None, act)
    q = tq.QConv(conv)
    x = rng.randn(2, 9, 11, 48).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, p: jq.conv_i8(x, p, act=act))(
        jnp.asarray(x), jq.quantize_conv(jp)))
    got = _nhwc(q(torch.from_numpy(x).permute(0, 3, 1, 2)))
    if act is None:
        np.testing.assert_array_equal(got, want)
    elif act == "gelu":
        assert np.abs(got - want).max() <= 1e-6
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= 4 * ulp).all()


def _lin_pair(rng, cin, cout):
    lin = torch.nn.Linear(cin, cout)
    w = (rng.randn(cin, cout) * 0.1).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                         "bias": torch.from_numpy(b)})
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, lin


def test_layer_norm_and_attention_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, T.HD).astype(np.float32)
    ln = torch.nn.LayerNorm(T.HD, eps=1e-5)
    g, b = rng.rand(T.HD).astype(np.float32) + 0.5, rng.randn(T.HD) \
        .astype(np.float32)
    ln.load_state_dict({"weight": torch.from_numpy(g),
                        "bias": torch.from_numpy(b)})
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    want = np.asarray(J._ln(jnp.asarray(x), {"g": g, "b": b}))
    assert np.abs(got - want).max() < TOL
    mha, jp = T.MHA(), {}
    for name in ("q", "k", "v", "o"):
        jp[name], lin = _lin_pair(rng, T.HD, T.HD)
        setattr(mha, name, lin)
    q, k = rng.randn(2, 5, T.HD).astype(np.float32), \
        rng.randn(2, 9, T.HD).astype(np.float32)
    with torch.no_grad():
        got = mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(k)).numpy()
    want = np.asarray(J._mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                             jp))
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("w,h", [(4, 4), (5, 3), (20, 12)])
def test_sincos_and_anchors_match_jax(w, h):
    """The embedding keeps its w-major flatten; the anchors keep inf where
    a prior falls outside (eps, 1 − eps)."""
    np.testing.assert_allclose(T.sincos_pe(w, h).numpy(),
                               np.asarray(J._sincos_pe(w, h)), atol=TOL)
    shapes = [(2 * h, 2 * w), (h, w), (max(1, h // 2), max(1, w // 2))]
    a, valid = T.anchors_for(shapes)
    ja, jvalid = J._anchors_for(shapes)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    ja = np.asarray(ja)
    assert np.array_equal(np.isinf(a.numpy()), np.isinf(ja))
    fin = np.isfinite(ja)
    np.testing.assert_allclose(a.numpy()[fin], ja[fin], atol=TOL)


@pytest.mark.parametrize("bf16_vals", [False, True])
@pytest.mark.parametrize("paired", [False, True])
def test_deform_attn_matches_jax(monkeypatch, bf16_vals, paired):
    """The 4-corner gathers, zero outside the map, with and without bf16
    values, in both gather formulations; sampling points run past every
    border (offsets up to 3 boxes)."""
    monkeypatch.setattr(J, "_PAIRED_GATHERS", paired)
    monkeypatch.setattr(T, "_PAIRED_GATHERS", paired)
    rng = np.random.RandomState(2)
    p, jp = T.DeformAttn(), {}
    for name, (cin, cout) in {"off": (T.HD, T.NH * T.NL * T.NDP * 2),
                              "attw": (T.HD, T.NH * T.NL * T.NDP),
                              "val": (T.HD, T.HD),
                              "out": (T.HD, T.HD)}.items():
        jp[name], lin = _lin_pair(rng, cin, cout)
        setattr(p, name, lin)
    shapes = [(8, 10), (4, 5), (2, 3)]
    n = sum(a * b for a, b in shapes)
    query = rng.randn(2, 11, T.HD).astype(np.float32)
    refer = rng.uniform(0.05, 0.95, (2, 11, 4)).astype(np.float32)
    values = rng.randn(2, n, T.NH, T.HD // T.NH).astype(np.float32)
    want = np.asarray(J._deform_attn(jp, jnp.asarray(query),
                                     jnp.asarray(refer), jnp.asarray(values),
                                     shapes, bf16_vals=bf16_vals))
    with torch.no_grad():
        got = T.deform_attn(p, torch.from_numpy(query),
                            torch.from_numpy(refer), torch.from_numpy(values),
                            shapes, bf16_vals=bf16_vals).numpy()
    assert np.abs(got - want).max() < TOL


# ---------------------------------------------------------------------------
# the model

def test_backbone_and_encoder_match_jax(asset, runs):
    x, (taps, feats, *_rest) = runs["128"]
    model = asset[2]
    with torch.no_grad():
        tt = model.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        tf = model.enc(*tt)
    for got, want in zip(tt, taps):
        _close_rel(_nhwc(got), want)
    for got, want in zip(tf, feats):
        _close_rel(_nhwc(got), want)


def test_decoder_matches_jax_on_the_same_maps(asset, runs):
    """The decoder alone, fed the JAX encoder's maps: the proposals and
    the decoded boxes and scores (the JAX forward decoded those maps)."""
    model = asset[2]
    _, (_, feats, top_val, topk, want_b, want_s) = runs["128"]
    tfeats = [torch.from_numpy(f.copy()).permute(0, 3, 1, 2) for f in feats]
    with torch.no_grad():
        _, _, t_val, t_topk, _, _ = model.dec.proposals(tfeats, 100)
        boxes, logits = model.dec(tfeats, 100, bf16_vals=False)
    np.testing.assert_array_equal(t_topk.numpy(), topk)
    assert np.abs(t_val.numpy() - top_val).max() < TOL
    assert np.abs(T.box_xyxy(boxes).numpy() - want_b).max() < TOL
    assert np.abs(torch.sigmoid(logits).numpy() - want_s).max() < TOL


@pytest.mark.parametrize("key,nq,decl", [("128", 100, None),
                                         ("64", 100, 2)])
def test_forward_matches_jax(asset, runs, key, nq, decl):
    """The whole forward: the encoder's top-k indices equal (the same
    anchors, the same order), then boxes and scores. At 64 × 64 the
    100 queries clamp to the 84 anchors, and two decoder layers run."""
    x, (_, _, top_val, topk, boxes, scores) = runs[key]
    model = asset[2]
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x))
        _, _, _, t_topk, _, _ = model.dec.proposals(feats, nq)
        got_b, got_s = model(torch.from_numpy(x), num_queries=nq,
                             decoder_layers=decl, bf16_vals=False)
    want_n = min(nq, top_val.shape[1])
    assert t_topk.shape == (2, want_n) and got_b.shape == (2, want_n, 4)
    assert got_s.shape == (2, want_n, 80)
    for row_t, row_j in zip(t_topk.numpy(), topk):
        assert set(row_t) == set(row_j)
    np.testing.assert_array_equal(t_topk.numpy(), topk)
    assert np.abs(got_b.numpy() - boxes).max() < TOL
    assert np.abs(got_s.numpy() - scores).max() < TOL
    assert float(scores.max()) > 0.5      # the trained model finds cars
