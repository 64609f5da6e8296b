"""The port's networks (InceptionV3, the three LPIPS backbones) against the JAX package's.

The same weights go into both packages: the JAX variables tree is built from
``jax.eval_shape(model.init, ...)`` (no Flax initialisation) with its leaves
filled from a numpy seed (He-normal kernels, BatchNorm variances in [0.8,
1.2]), and carried into the port by ``inception_state_from_flax`` /
``lpips_state_from_flax``. Inputs are made with numpy from a seed; the JAX
side runs eagerly (``model.apply`` under its ``high_precision``), as its
extractors' jitted forward would compile for minutes on this CPU.

Tolerances: an Inception tap within ``INCEPTION_RTOL`` (1e-4) of its mean
absolute value (two float32 convolution stacks of up to 94 layers summing in
another order; about 1e-5 is seen); a resized image within ``RESIZE_ATOL``
(5e-3 on the 0-255 scale, 2e-5 relative: JAX computes its resize weights in
float32); an LPIPS score within ``LPIPS_ATOL`` (1e-5). The weight carry is also
fed from the converters' ``.npz`` over the torch mirrors of
``tests/helpers/torch_mirrors.py`` (checkpoint key names), and must then
reproduce the mirrors' outputs (``MIRROR_RTOL`` 1e-5 of the scale). Also: the
manifest's errors equal JAX's, the weights gate, and the network's place
(moves with ``.to()``, not in the metric's ``state_dict``).
"""
import os
import pickle
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.image import generative as jgen
from metrics_tpu.models import inception as jinc
from metrics_tpu.models import lpips as jlp
from metrics_tpu.utils.compute import high_precision as jax_high_precision
import metrics_tpu_torch as tmt
from metrics_tpu_torch.interop import inception_state_from_flax, lpips_state_from_flax
from metrics_tpu_torch.models import inception as tinc
from metrics_tpu_torch.models import lpips as tlp
from metrics_tpu_torch.models.manifest import meta_module, state_from_flax
from tests.helpers.torch_mirrors import (
    TorchAlexLPIPSMirror,
    TorchInceptionMirror,
    randomize_inception_,
    randomize_lpips_,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import convert_inception_weights  # noqa: E402
import convert_lpips_weights  # noqa: E402

INCEPTION_RTOL = 1e-4
RESIZE_ATOL = 5e-3
LPIPS_ATOL = 1e-5
MIRROR_RTOL = 1e-5
TAPS = tinc.VALID_FEATURES


def _fill(shapes, seed):
    """A Flax variables tree of ``shapes`` filled from a numpy seed."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith(("var", "scale")):
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name.endswith(("mean", "bias")):
            return (rng.randn(*s.shape) * 0.05).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_variables(module, *dummy, seed=0):
    return _fill(jax.eval_shape(module.init, jax.random.PRNGKey(0), *dummy), seed)


def _nhwc(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def _assert_scaled(got, want, rtol, label):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = np.abs(want).mean() + 1e-12
    err = np.abs(got - want).max() / scale
    assert err < rtol, f"{label}: max |err| {err:.3g} of the scale {scale:.3g}"


@pytest.fixture(scope="module")
def inception_variables():
    return _jax_variables(jinc.InceptionV3(), jnp.zeros((1, 75, 75, 3)), seed=0)


@pytest.fixture(scope="module")
def port_inception(inception_variables):
    model = meta_module(tinc.InceptionV3).to_empty(device="cpu")
    model.load_state_dict(inception_state_from_flax(inception_variables))
    return model.eval()


# ---------------------------------------------------------------- InceptionV3
BLOCKS = {
    "BasicConv2d": (lambda: jinc.BasicConv2d(12, (3, 3), padding=((1, 1), (1, 1))),
                    lambda cin: tinc.BasicConv2d(cin, 12, 3, padding=1)),
    "InceptionA": (lambda: jinc.InceptionA(pool_features=8), lambda cin: tinc.InceptionA(cin, 8)),
    "InceptionB": (lambda: jinc.InceptionB(), lambda cin: tinc.InceptionB(cin)),
    "InceptionC": (lambda: jinc.InceptionC(channels_7x7=8), lambda cin: tinc.InceptionC(cin, 8)),
    "InceptionD": (lambda: jinc.InceptionD(), lambda cin: tinc.InceptionD(cin)),
    "InceptionE-avg": (lambda: jinc.InceptionE(pool_type="avg"), lambda cin: tinc.InceptionE(cin, "avg")),
    "InceptionE-max": (lambda: jinc.InceptionE(pool_type="max"), lambda cin: tinc.InceptionE(cin, "max")),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_inception_block_matches_jax(name):
    make_jax, make_port = BLOCKS[name]
    cin = 16
    x = np.random.RandomState(len(name)).randn(2, cin, 9, 9).astype(np.float32)
    jmod = make_jax()
    variables = _jax_variables(jmod, jnp.zeros((1, 9, 9, cin)), seed=len(name))
    want = np.asarray(jax_high_precision(jmod.apply)(variables, _nhwc(x))).transpose(0, 3, 1, 2)
    port = meta_module(make_port, cin).to_empty(device="cpu")
    port.load_state_dict(state_from_flax(variables, meta_module(make_port, cin), "converter"))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    _assert_scaled(got, want, INCEPTION_RTOL, name)


@pytest.fixture(scope="module")
def inception_taps_75(inception_variables, port_inception):
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32)
    want = jax_high_precision(jinc.InceptionV3().apply)(inception_variables, _nhwc(x))
    got = tinc._apply(port_inception, torch.from_numpy(x))
    return got, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("tap", TAPS)
def test_inception_v3_taps_match_jax(inception_taps_75, tap):
    got, want = inception_taps_75
    assert set(got) == set(want) == set(TAPS)
    _assert_scaled(got[tap], want[tap], INCEPTION_RTOL, tap)


@pytest.mark.parametrize("size", [256, 320, 299, 75], ids=["up-256", "down-320", "same-299", "up-75"])
def test_resize_matches_jax(size):
    imgs = np.random.RandomState(size).randint(0, 256, (2, 3, size, size)).astype(np.float32)
    want = np.asarray(jinc._resize_bilinear(jnp.asarray(imgs)))
    got = tinc._resize_bilinear(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 3, 299, 299)
    np.testing.assert_allclose(got, want, atol=RESIZE_ATOL, rtol=0)


@pytest.mark.parametrize("size", [256, 320], ids=["upsampling", "downsampling"])
def test_extractor_end_to_end_matches_jax(inception_variables, size):
    imgs = np.random.RandomState(size).randint(0, 256, (2, 3, size, size), dtype=np.uint8)
    jext = jinc.InceptionV3Extractor(feature="2048", params=inception_variables)
    jext._forward = lambda params, x: jax_high_precision(jext.model.apply)(params, x)  # eager: no compile
    want = np.asarray(jext(jnp.asarray(imgs)))
    text = tinc.InceptionV3Extractor(feature="2048", params=inception_variables, device="cpu")
    got = text(torch.from_numpy(imgs))
    _assert_scaled(got, want, INCEPTION_RTOL, f"extractor from {size}")
    # float inputs are divided by 255 too
    got_float = text(torch.from_numpy(imgs.astype(np.float32)))
    torch.testing.assert_close(got_float, got, rtol=0, atol=0)


# ---------------------------------------------------------------- LPIPS
LPIPS_CASES = [("alex", 64), ("vgg", 64), ("squeeze", 64), ("squeeze", 65)]


@pytest.fixture(scope="module")
def lpips_variables():
    out = {}
    for net_type in ("alex", "vgg", "squeeze"):
        dummy = jnp.zeros((1, 64, 64, 3))
        out[net_type] = _jax_variables(jlp.LPIPSNet(net_type=net_type), dummy, dummy, seed=3)
    return out


@pytest.mark.parametrize("net_type,size", LPIPS_CASES, ids=[f"{n}-{s}" for n, s in LPIPS_CASES])
def test_lpips_backbones_match_jax(lpips_variables, net_type, size):
    rng = np.random.RandomState(size)
    img1 = rng.uniform(-1, 1, (3, 3, size, size)).astype(np.float32)
    img2 = rng.uniform(-1, 1, (3, 3, size, size)).astype(np.float32)
    variables = lpips_variables[net_type]
    jext = jlp.LPIPSExtractor(net_type=net_type, params=variables)
    jext._forward = lambda params, a, b: jax_high_precision(jext.model.apply)(params, a, b)
    want = np.asarray(jext(jnp.asarray(img1), jnp.asarray(img2)))
    got = tlp.LPIPSExtractor(net_type=net_type, params=variables, device="cpu")(torch.from_numpy(img1),
                                                                              torch.from_numpy(img2))
    np.testing.assert_allclose(got.numpy(), want, atol=LPIPS_ATOL, rtol=0)


@pytest.mark.parametrize("size,pads", [(64, [0, 1, 0, 1]), (65, [1, 1, 1, 1]), (8, [0, 1, 0, 1])])
def test_squeezenet_pads_same_like_tensorflow(size, pads):
    x = torch.ones(1, 1, size, size)
    padded = tlp._same_pad(x, 3, 2)
    assert list(padded.shape[-2:]) == [size + pads[2] + pads[3], size + pads[0] + pads[1]]
    # the padding goes at the end of an even side: the first row and column stay data
    assert padded[0, 0, 0, 0] == (1.0 if pads[0] == 0 else 0.0)
    assert padded[0, 0, -1, -1] == 0.0


# ---------------------------------------------------------------- the weight carry
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def inception_mirror_npz(tmp_path_factory):
    mirror = TorchInceptionMirror()
    randomize_inception_(mirror, seed=7)
    converted = convert_inception_weights.convert_state_dict({k: v.numpy() for k, v in mirror.state_dict().items()})
    path = tmp_path_factory.mktemp("inception") / "w.npz"
    np.savez(path, **converted)
    return mirror, converted, str(path)


@pytest.mark.parametrize("form", ["npz_path", "nested", "flat"])
def test_inception_carry_from_converter_npz_reproduces_the_mirror(inception_mirror_npz, form):
    mirror, converted, path = inception_mirror_npz
    if form == "npz_path":
        ext = tinc.InceptionV3Extractor(feature="logits", npz_path=path, device="cpu")
    else:
        params = tinc.params_from_npz(path) if form == "nested" else converted
        state = inception_state_from_flax(params)
        # the port's keys are the checkpoint's (torch-fidelity's): the carry gives back the mirror's tensors
        for key, value in mirror.state_dict().items():
            if not key.endswith("num_batches_tracked"):
                assert torch.equal(state[key], value), key
        ext = tinc.InceptionV3Extractor(feature="logits", params=params, device="cpu")
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32)
    got = tinc._apply(ext.model, torch.from_numpy(x))
    with torch.no_grad():
        want = mirror(torch.from_numpy(x))
    for tap in TAPS:
        _assert_scaled(got[tap], want[tap].numpy(), MIRROR_RTOL, tap)


@pytest.mark.parametrize("form", ["npz_path", "nested", "flat"])
def test_lpips_carry_from_converter_npz_reproduces_the_mirror(tmp_path, form):
    mirror = TorchAlexLPIPSMirror()
    randomize_lpips_(mirror, seed=5)
    converted = convert_lpips_weights.convert_state_dict("alex", {k: v.numpy() for k, v in mirror.state_dict().items()})
    path = tmp_path / "w.npz"
    np.savez(path, **converted)
    if form == "npz_path":
        ext = tlp.LPIPSExtractor("alex", npz_path=str(path), device="cpu")
    else:
        params = tinc.params_from_npz(str(path)) if form == "nested" else converted
        assert set(lpips_state_from_flax(params, "alex")) == set(tlp.LPIPSNet("alex").state_dict())
        ext = tlp.LPIPSExtractor("alex", params=params, device="cpu")
    rng = np.random.RandomState(9)
    img1 = torch.from_numpy((rng.rand(3, 3, 64, 64) * 2 - 1).astype(np.float32))
    img2 = torch.from_numpy((rng.rand(3, 3, 64, 64) * 2 - 1).astype(np.float32))
    with torch.no_grad():
        want = mirror(img1, img2)
    torch.testing.assert_close(ext(img1, img2), want, atol=LPIPS_ATOL, rtol=0)


def test_carry_reproduces_jax_outputs_from_jax_params(inception_variables, port_inception, inception_taps_75):
    """Both input forms of the JAX params (the variables tree and its flat keys) carry the same state."""
    nested = inception_state_from_flax(inception_variables)
    flat = inception_state_from_flax(_flat(jax.tree_util.tree_map(np.asarray, inception_variables)))
    assert nested.keys() == flat.keys() == port_inception.state_dict().keys()
    for key in nested:
        assert torch.equal(nested[key], flat[key]), key


# ---------------------------------------------------------------- the manifest and the gate
def _jax_error(params):
    with pytest.raises(ValueError) as err:
        jinc.InceptionV3Extractor(params=params)
    return str(err.value)


def _port_error(params):
    with pytest.raises(ValueError) as err:
        tinc.InceptionV3Extractor(params=params, device="cpu")
    return str(err.value)


def _edited(variables, edit):
    tree = jax.tree_util.tree_map(np.asarray, variables)
    tree = {k: {kk: vv for kk, vv in v.items()} for k, v in tree.items()}
    edit(tree)
    return tree


@pytest.mark.parametrize("case", ["missing", "extra", "shape", "all_three"])
def test_manifest_errors_equal_jax(inception_variables, case):
    def edit(tree):
        if case in ("missing", "all_three"):
            del tree["params"]["Mixed_5b"]
        if case in ("extra", "all_three"):
            tree["params"]["bogus"] = {"kernel": np.zeros((1, 1), np.float32)}
        if case in ("shape", "all_three"):
            tree["params"]["fc_bias"] = np.zeros((7,), np.float32)

    params = _edited(inception_variables, edit)
    message = _port_error(params)
    assert message == _jax_error(params)
    assert "python tools/convert_inception_weights.py" in message
    if case == "shape":
        assert "params/fc_bias: expected (1008,), got (7,)" in message


def test_lpips_manifest_error_names_the_converter_for_its_backbone(lpips_variables):
    params = _edited(lpips_variables["vgg"], lambda tree: tree["params"].pop("lin4"))
    with pytest.raises(ValueError, match=r"missing 1 parameter\(s\):\n  - params/lin4/kernel") as err:
        tlp.LPIPSExtractor("vgg", params=params, device="cpu")
    assert "convert_lpips_weights.py vgg" in str(err.value)
    with pytest.raises(ValueError, match="net_type"):
        lpips_state_from_flax(lpips_variables["vgg"], "resnet")


GATED = [
    ("FrechetInceptionDistance", {}),
    ("KernelInceptionDistance", {}),
    ("InceptionScore", {}),
    ("LearnedPerceptualImagePatchSimilarity", {}),
]


@pytest.mark.parametrize("name,kwargs", GATED, ids=[g[0] for g in GATED])
def test_weights_gate_matches_jax(name, kwargs):
    with pytest.raises(RuntimeError) as jerr:
        getattr(jgen, name)(**kwargs)
    with pytest.raises(RuntimeError) as terr:
        getattr(tmt, name)(device="cpu", **kwargs)
    assert str(terr.value) == str(jerr.value)
    assert "allow_random_weights=True" in str(terr.value)
    with pytest.warns(UserWarning, match="deterministic random initialization"):
        getattr(tmt, name)(allow_random_weights=True, device="cpu", **kwargs)


def test_gate_order_and_conflicts(tmp_path):
    with pytest.raises(ValueError, match="net_type"):  # the backbone is checked before the gate
        tmt.LearnedPerceptualImagePatchSimilarity(net_type="resnet", device="cpu")
    with pytest.raises(ValueError, match="feature"):
        tmt.FrechetInceptionDistance(feature=100, device="cpu")
    path = tmp_path / "w.npz"
    np.savez(path, a=np.zeros(1))
    for make in (lambda: tinc.InceptionV3Extractor(params={}, npz_path=str(path), device="cpu"),
                 lambda: tlp.LPIPSExtractor("alex", params={}, npz_path=str(path), device="cpu")):
        with pytest.raises(ValueError, match="EITHER"):
            make()
    # a callable feature needs no waiver
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warnings.filterwarnings("ignore", message=".*will save all extracted features.*")
        tmt.FrechetInceptionDistance(feature=lambda x: x, device="cpu")


def test_network_moves_with_the_metric_and_stays_out_of_its_state_dict():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fid = tmt.FrechetInceptionDistance(feature=64, allow_random_weights=True, device="cpu")
        lpips = tmt.LearnedPerceptualImagePatchSimilarity(allow_random_weights=True, device="cpu")
    assert fid.inception._model is None  # the random network waits for the first image
    assert set(fid.state_dict()) == set() and list(fid.parameters()) == []
    fid.persistent(True)
    assert set(fid.state_dict()) == {"real_features", "fake_features"}
    assert set(lpips.state_dict()) == set()
    lpips.persistent(True)
    assert set(lpips.state_dict()) == {"sum_scores", "total"}
    # the same seed gives the same weights; pickling keeps them
    other = tinc.InceptionV3Extractor(feature="64", seed=0, device="cpu")
    for key, value in other.params.items():
        assert torch.equal(fid.inception.params[key], value), key
    clone = pickle.loads(pickle.dumps(fid))
    assert torch.equal(clone.inception.params["fc.weight"], fid.inception.params["fc.weight"])
    # a dtype cast leaves the network as it is; .to() a device moves it with the states (the
    # meta device stands in for the card here)
    fid.double()
    assert fid.inception.params["fc.weight"].dtype == torch.float32
    fid.to("meta")
    assert fid.device.type == "meta" and fid.inception.device.type == "meta"
    assert all(t.device.type == "meta" for t in fid.inception.params.values())
