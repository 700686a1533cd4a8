"""The port's augmentation data path against the JAX package, on the CPU.

Inputs are made from a seed with numpy and given to both packages; the JAX
side is jitted through ``compile_quickly``.  JAX's PRNG cannot be
reproduced in torch, so parity comes from pinned parameters (a range of
width 0, p = 1: the JAX draw is a constant), from injected draws (the test
copies the JAX transform's key path, then hands the draws to the port's
``apply``), and from distributions (the port's counterparts of
``tests/test_stratified_oneof.py``).

Tolerances: images atol 1e-2 on the 0-255 scale before ``Normalize``,
2e-4 after it; masks equal, except Rotate's nearest taps whose source
coordinate lies within 1e-3 of a half-integer (the two packages' sin and
cos may round the coordinate the other way there), at most 0.1 % of the
pixels.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import compile_quickly  # noqa: E402

from image_segmentation_lab_tpu.data import transforms as JT  # noqa: E402
from image_segmentation_lab_tpu.data.pipeline import \
    Pipeline as JPipeline  # noqa: E402
from image_segmentation_lab_tpu_torch.data import albu_yaml  # noqa: E402
from image_segmentation_lab_tpu_torch.data import transforms as T  # noqa: E402
from image_segmentation_lab_tpu_torch.data.pipeline import \
    Pipeline  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PINNED_YAML = REPO / "tests/data/kvasir_train_transform_pinned.yaml"
RAW_TOL = dict(rtol=0, atol=1e-2)
NORM_TOL = dict(rtol=0, atol=2e-4)
SIZE = 40
N = 3


def batch(seed, n=N, h=SIZE, w=SIZE):
    """uint8 images (n, h, w, 3) and float masks (n, h, w) of 3 classes."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    masks = rng.randint(0, 3, (n, h, w)).astype(np.float32)
    return imgs, masks


def compose(*transforms):
    return {"transform": {"__class_fullname__": "Compose", "p": 1.0,
                          "transforms": list(transforms)}}


def leaf(name, **kw):
    return {"__class_fullname__": name, "p": 1.0, **kw}


def run_jax(spec, imgs, masks, key=0):
    pipe = JPipeline.from_dict(spec)
    fn = compile_quickly(jax.jit(pipe.batched_apply),
                         jax.random.PRNGKey(key), imgs, masks)
    out, om = fn(jax.random.PRNGKey(key), imgs, masks)
    return np.asarray(out), np.asarray(om)


def run_port(spec, imgs, masks, seed=0):
    out, om = Pipeline.from_dict(spec)(torch.Generator().manual_seed(seed),
                                       imgs, masks)
    return out.permute(0, 2, 3, 1).numpy(), om.numpy()


def half_integer_pixels(shape, angle_deg):
    """Where a rotation's source coordinate (float64) lies within 1e-3 of
    a half-integer: there the nearest tap may go either way."""
    h, w = shape
    a = math.radians(angle_deg)
    yy, xx = np.meshgrid(np.arange(h) - (h - 1) / 2, np.arange(w)
                         - (w - 1) / 2, indexing="ij")
    src_y = math.cos(a) * yy + math.sin(a) * xx + (h - 1) / 2
    src_x = -math.sin(a) * yy + math.cos(a) * xx + (w - 1) / 2

    def near_half(v):
        return np.abs(v - np.floor(v) - 0.5) < 1e-3
    return near_half(src_y) | near_half(src_x)


def assert_masks_equal(out, ref, rotate_angle=None):
    if rotate_angle is None:
        np.testing.assert_array_equal(out, ref)
        return
    off = out != ref
    excused = half_integer_pixels(ref.shape[1:], rotate_angle)[None]
    assert not (off & ~excused).any(), "mask taps off away from a half"
    assert off.mean() <= 1e-3, off.mean()


# ---------------------------------------------------------------- the YAML

@pytest.mark.parametrize("path", sorted(
    (REPO / "configs/augmentation").glob("*.yaml")), ids=lambda p: p.name)
def test_albu_yaml_equals_safe_load(path):
    assert albu_yaml.load(path) == yaml.safe_load(path.read_text())


def test_albu_yaml_reads_the_pinned_copy():
    assert albu_yaml.load(PINNED_YAML) == yaml.safe_load(
        PINNED_YAML.read_text())


SUBSET_CASES = ("a: 1\nb: [1, 2.5, x, 'y z', \"q\"]\nc:\n- 1\n- k: v\n"
                "  j: []\n",
                "a: .5\nb: 1e-3\nc: -.5\nd: 1.\ne: yes\nf: ~\ng: 'it''s'\n"
                "h:\ni: 2.0.6\nj: -3\nk: 1.5e+3  # a comment\n",
                "- - 1\n  - 2\n- 3\n",
                "x:\n  - a\n  -\n    b: 1\n")


@pytest.mark.parametrize("source", SUBSET_CASES)
def test_albu_yaml_scalars_and_nesting_equal_safe_load(source):
    assert albu_yaml.loads(source) == yaml.safe_load(source)


@pytest.mark.parametrize("source, line", [
    ("a: 1\nb: &x 2\n", 2), ("a:\n  b: {c: 1}\n", 2), ("a: |\n  x\n", 1),
    ("a: *x\n", 1), ("a: !!int 3\n", 1), ("---\na: 1\n", 1),
    ("a: 0x10\n", 1), ("a: [1, [2]]\n", 1), ("a:\n    b: 1\n  c: 2\n", 3),
    ("a:\n\tb: 1\n", 2)])
def test_albu_yaml_rejects_lines_outside_the_subset(source, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        albu_yaml.loads(source)


# ------------------------------------------------- pinned transforms

PINNED = {
    "Resize_bilinear": (leaf("Resize", height=48, width=56), False),
    "Resize_nearest": (leaf("Resize", height=33, width=64, interpolation=0,
                            mask_interpolation=1), False),
    "HorizontalFlip": (leaf("HorizontalFlip"), False),
    "VerticalFlip": (leaf("VerticalFlip"), False),
    "PadIfNeeded_constant": (leaf("PadIfNeeded", min_height=47, min_width=52,
                                  border_mode=0, fill=7.0, fill_mask=2.0),
                             False),
    "PadIfNeeded_replicate": (leaf("PadIfNeeded", min_height=47,
                                   min_width=44, border_mode=1), False),
    "PadIfNeeded_reflect": (leaf("PadIfNeeded", min_height=45, min_width=52,
                                 border_mode=2), False),
    "PadIfNeeded_reflect101": (leaf("PadIfNeeded", min_height=47,
                                    min_width=41), False),
    "Blur": (leaf("Blur", blur_limit=[5, 5]), False),
    "GaussianBlur_sigma0": (leaf("GaussianBlur", blur_limit=[7, 7]), False),
    "GaussianBlur_sigma0_k9": (leaf("GaussianBlur", blur_limit=[9, 9]),
                               False),
    "GaussianBlur_sigma": (leaf("GaussianBlur", blur_limit=[5, 5],
                                sigma_limit=[1.5, 1.5]), False),
    "Defocus": (leaf("Defocus", radius=[4, 4], alias_blur=[0.3, 0.3]),
                False),
    "GlassBlur_no_rounds": (leaf("GlassBlur", sigma=1.2, max_delta=3,
                                 iterations=0), False),
    "RandomBrightnessContrast": (leaf("RandomBrightnessContrast",
                                      brightness_limit=[0.1, 0.1],
                                      contrast_limit=[0.25, 0.25]), False),
    "RandomBrightnessContrast_mean": (leaf(
        "RandomBrightnessContrast", brightness_limit=[-0.15, -0.15],
        contrast_limit=[0.2, 0.2], brightness_by_max=False), False),
    "RandomGamma": (leaf("RandomGamma", gamma_limit=[70.0, 70.0]), False),
    "HueSaturationValue": (leaf("HueSaturationValue",
                                hue_shift_limit=[5.0, 5.0],
                                sat_shift_limit=[-10.0, -10.0],
                                val_shift_limit=[10.0, 10.0]), False),
    "ISONoise_p0": (dict(leaf("ISONoise"), p=0.0), False),
    "Normalize": (leaf("Normalize", mean=[0.563, 0.328, 0.244],
                       std=[0.315, 0.222, 0.19]), True),
    "ToTensorV2": (leaf("ToTensorV2"), False),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_pinned_transform_matches_jax(name):
    spec, normalized = PINNED[name]
    imgs, masks = batch(seed=len(name))
    ref, ref_m = run_jax(compose(spec), imgs, masks)
    out, out_m = run_port(compose(spec), imgs, masks)
    assert out.shape == ref.shape and out_m.shape == ref_m.shape
    np.testing.assert_allclose(out, ref, **(NORM_TOL if normalized
                                            else RAW_TOL))
    assert_masks_equal(out_m, ref_m)


@pytest.mark.parametrize("border_mode", [0, 1, 2, 4])
def test_rotate_matches_jax_in_each_border_mode(border_mode):
    spec = leaf("Rotate", limit=[30.0, 30.0], border_mode=border_mode,
                fill=11.0, fill_mask=2.0)
    imgs, masks = batch(seed=40 + border_mode, h=36, w=44)
    ref, ref_m = run_jax(compose(spec), imgs, masks)
    out, out_m = run_port(compose(spec), imgs, masks)
    np.testing.assert_allclose(out, ref, **RAW_TOL)
    assert_masks_equal(out_m, ref_m, rotate_angle=30.0)


def test_resize_to_the_same_size_is_the_identity():
    imgs = torch.rand(2, 3, 8, 8)
    masks = torch.rand(2, 8, 8)
    oi, om = T.Resize(8, 8).apply(imgs, masks, {})
    assert oi is imgs and om is masks


# --------------------------------------------------- injected draws

def jax_vmapped(jax_transform, params_fn, imgs, masks, seed):
    """The JAX transform's ``apply`` per image with keys split from
    ``seed``, and ``params_fn(key, img)``: the draws its key path makes."""
    keys = jax.random.split(jax.random.PRNGKey(seed), imgs.shape[0])
    x = jnp.asarray(imgs, jnp.float32)
    m = jnp.asarray(masks)
    fn = compile_quickly(jax.jit(jax.vmap(jax_transform.apply)), keys, x, m)
    out, om = fn(keys, x, m)
    params = jax.vmap(params_fn)(keys, x)
    return np.asarray(out), np.asarray(om), {
        k: torch.from_numpy(np.asarray(v)) for k, v in params.items()}


def port_apply(transform, imgs, masks, params):
    x = torch.from_numpy(imgs.astype(np.float32)).permute(0, 3, 1, 2)
    out, om = transform.apply(x.contiguous(), torch.from_numpy(masks),
                              params)
    return out.permute(0, 2, 3, 1).numpy(), om.numpy()


def test_glass_blur_with_the_jax_displacements_matches_jax():
    kw = dict(sigma=1.0, max_delta=3, iterations=2, p=1.0)
    jt = JT.GlassBlur(**kw)
    imgs, masks = batch(seed=51)
    h, w = imgs.shape[1:3]

    def draws(key, img):
        d = jt.max_delta
        dydx = jnp.stack([jax.random.randint(jax.random.fold_in(key, i),
                                             (2, h, w), -d, d)
                          for i in range(jt.iterations)], axis=1)
        return {"dy": dydx[0].astype(jnp.int32),
                "dx": dydx[1].astype(jnp.int32)}

    ref, ref_m, params = jax_vmapped(jt, draws, imgs, masks, seed=5)
    params = {k: v.long() for k, v in params.items()}
    out, out_m = port_apply(T.GlassBlur(**kw), imgs, masks, params)
    np.testing.assert_allclose(out, ref, **RAW_TOL)
    assert_masks_equal(out_m, ref_m)


def test_iso_noise_with_the_jax_draws_matches_jax():
    kw = dict(color_shift=(0.05, 0.2), intensity=(0.1, 0.5), p=1.0)
    jt = JT.ISONoise(**kw)
    imgs, masks = batch(seed=52)

    def draws(key, img):
        # transforms.py: k1, k2, k3, k4 = split(key, 4), in this order
        k1, k2, k3, k4 = jax.random.split(key, 4)
        shape = img.shape[:2]
        return {"intensity": jax.random.uniform(k1, (), jnp.float32,
                                                *jt.intensity),
                "color_shift": jax.random.uniform(k2, (), jnp.float32,
                                                  *jt.color_shift),
                "lum_normal": jax.random.normal(k3, shape),
                "hue_normal": jax.random.normal(k4, shape)}

    ref, ref_m, params = jax_vmapped(jt, draws, imgs, masks, seed=6)
    out, out_m = port_apply(T.ISONoise(**kw), imgs, masks, params)
    np.testing.assert_allclose(out, ref, **RAW_TOL)
    assert_masks_equal(out_m, ref_m)


def test_motion_blur_with_the_jax_draws_matches_jax():
    kw = dict(blur_limit=(3, 9), direction_range=(-0.5, 0.8), p=1.0)
    jt = JT.MotionBlur(**kw)
    imgs, masks = batch(seed=53, n=4)

    def draws(key, img):
        k_size, k_angle, k_dir, k_shift = jax.random.split(key, 4)
        n_sizes = (jt.kmax - jt.kmin) // 2 + 1
        return {"size": jt.kmin + 2 * jax.random.randint(k_size, (), 0,
                                                          n_sizes),
                "angle": jax.random.uniform(k_angle, (), jnp.float32, 0.0,
                                            math.pi),
                "direction": jax.random.uniform(k_dir, (), jnp.float32,
                                                *jt.direction_range),
                "shift": jax.random.uniform(k_shift, (2,), jnp.float32,
                                            -1.0, 1.0)}

    ref, ref_m, params = jax_vmapped(jt, draws, imgs, masks, seed=7)
    params["size"] = params["size"].long()
    out, out_m = port_apply(T.MotionBlur(**kw), imgs, masks, params)
    np.testing.assert_allclose(out, ref, **RAW_TOL)
    assert_masks_equal(out_m, ref_m)


def test_random_crop_with_the_jax_offsets_matches_jax():
    jt = JT.RandomCrop(height=24, width=31)
    imgs, masks = batch(seed=54, n=4)

    def draws(key, img):
        ky, kx = jax.random.split(key)
        h, w = img.shape[:2]
        return {"y0": jax.random.randint(ky, (), 0, h - 24 + 1),
                "x0": jax.random.randint(kx, (), 0, w - 31 + 1)}

    ref, ref_m, params = jax_vmapped(jt, draws, imgs, masks, seed=8)
    params = {k: v.long() for k, v in params.items()}
    assert len(set(params["y0"].tolist())) > 1  # the offsets differ
    out, out_m = port_apply(T.RandomCrop(24, 31), imgs, masks, params)
    np.testing.assert_array_equal(out, ref)
    assert_masks_equal(out_m, ref_m)


def test_rotate_per_image_angles_match_jax_one_by_one():
    """Per-image angles in one batched gather against JAX per image."""
    jt = JT.Rotate(limit=(-90, 90), border_mode=4, p=1.0)
    imgs, masks = batch(seed=55, n=4)

    def draws(key, img):
        return {"angle": jax.random.uniform(key, (), jnp.float32, -90, 90)}

    ref, ref_m, params = jax_vmapped(jt, draws, imgs, masks, seed=9)
    out, out_m = port_apply(T.Rotate(limit=(-90, 90), border_mode=4), imgs,
                            masks, params)
    np.testing.assert_allclose(out, ref, **RAW_TOL)
    for i, angle in enumerate(params["angle"].tolist()):
        assert_masks_equal(out_m[i:i + 1], ref_m[i:i + 1], angle)


# -------------------------------------------------- stratified execution

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 17, 24, 32])
def test_apportion_and_representable_equal_jax(n):
    grid = [[1.0], [0.5, 0.5], [1 / 3] * 3, [0.1, 0.9], [0.9, 0.05, 0.05],
            [0.25] * 4, [0.2, 0.3, 0.5], [0.0, 1.0], [0.45, 0.45, 0.1],
            [0.5 * 0.5, 0.5 * 0.5, 0.5], [0.7, 0.2, 0.1, 0.0]]
    for weights in grid:
        assert T._apportion(n, weights) == JT._apportion(n, weights)
        assert (T._stratify_representable(n, weights)
                == JT._stratify_representable(n, weights))


class AddConst(T.Transform):
    """Adds a constant: shows which branch ran."""

    def __init__(self, c, p=0.5):
        super().__init__(p=p)
        self.c = float(c)

    def apply(self, imgs, masks, params):
        return imgs + self.c, masks


def zeros(n):
    return torch.zeros(n, 3, 2, 2)


def firsts(out):
    return out[:, 0, 0, 0].round().long().tolist()


def test_oneof_batched_exactly_one_branch_and_order():
    one = T.OneOf([AddConst(1), AddConst(2), AddConst(3)], p=1.0)
    n = 12
    imgs = (100.0 * torch.arange(n, dtype=torch.float32)).view(
        n, 1, 1, 1).expand(n, 3, 4, 4).contiguous()
    masks = torch.arange(n, dtype=torch.float32).view(n, 1, 1).expand(
        n, 4, 4).contiguous()
    out, om = one.batched(torch.Generator().manual_seed(0), imgs, masks)
    deltas = [round(float(v)) - 100 * i for i, v in
              enumerate(out[:, 0, 0, 0])]
    assert set(deltas) <= {1, 2, 3}
    assert [deltas.count(c) for c in (1, 2, 3)] == T._apportion(n, [1 / 3]
                                                                * 3)
    assert om[:, 0, 0].tolist() == list(range(n))  # order restored


def test_oneof_batched_marginals_within_one_over_n():
    one = T.OneOf([AddConst(1), AddConst(2)], p=1.0)
    n, trials = 6, 300
    g = torch.Generator().manual_seed(1)
    hits = torch.zeros(n)
    for _ in range(trials):
        out, _ = one.batched(g, zeros(n), None)
        hits += (out[:, 0, 0, 0] == 1.0).float()
    # counts / n = 0.5 for every image, the permutation uniform
    np.testing.assert_allclose((hits / trials).numpy(), 0.5, atol=0.1)


def test_oneof_gated_adds_an_identity_branch():
    one = T.OneOf([AddConst(5)], p=0.5)
    out, _ = one.batched(torch.Generator().manual_seed(3), zeros(8), None)
    assert sorted(firsts(out)) == [0] * 4 + [5] * 4


def test_p_gated_leaf_is_stratified_with_a_fixed_count():
    out, _ = AddConst(7, p=0.25).batched(torch.Generator().manual_seed(1),
                                         zeros(8), None)
    assert firsts(out).count(7) == 2


def test_zero_quota_falls_back_to_per_image_selection():
    """p = 0.1 at batch 4 apportions no slot: the transform must still fire
    about one time in ten per image."""
    t = AddConst(9, p=0.1)
    g = torch.Generator().manual_seed(2)
    fired = sum(firsts(t.batched(g, zeros(4), None)[0]).count(9)
                for _ in range(500))
    assert 0.06 < fired / 2000 < 0.14


def test_zero_quota_oneof_falls_back():
    one = T.OneOf([AddConst(1, p=0.9), AddConst(2, p=0.05),
                   AddConst(3, p=0.05)], p=1.0)
    g = torch.Generator().manual_seed(4)
    seen = set()
    for _ in range(300):
        seen |= set(firsts(one.batched(g, zeros(4), None)[0]))
    assert seen == {1, 2, 3}


def test_the_env_switch_selects_per_image(monkeypatch):
    monkeypatch.setenv("ISLT_NO_STRATIFIED_ONEOF", "1")
    one = T.OneOf([AddConst(1), AddConst(2)], p=1.0)
    g = torch.Generator().manual_seed(5)
    counts = [firsts(one.batched(g, zeros(4), None)[0]).count(1)
              for _ in range(400)]
    assert len(set(counts)) > 1  # per-image choice: the count varies
    np.testing.assert_allclose(sum(counts) / 1600, 0.5, atol=0.05)


def test_container_child_force_applies_on_its_slice():
    inner = T.Compose([AddConst(1, p=1.0)], p=1.0)
    one = T.OneOf([inner, AddConst(2, p=1.0)], p=1.0)
    out, _ = one.batched(torch.Generator().manual_seed(0), zeros(4), None)
    assert sorted(firsts(out)) == [1, 1, 2, 2]


def test_kvasir_sub_batch_sizes_are_the_apportionment():
    """Each OneOf's and each p < 1 leaf's sub-batch at batch 16 of the
    Kvasir YAML, as the JAX package apportions it."""
    pipe = Pipeline.from_yaml(REPO / "configs/augmentation/"
                              "kvasir_train_transform.yaml")
    jpipe = JPipeline.from_yaml(REPO / "configs/augmentation/"
                                "kvasir_train_transform.yaml")
    seen = []
    for t in pipe.root.transforms:
        for child in getattr(t, "transforms", [t]):
            orig = child.force_apply

            def spy(g, imgs, masks, orig=orig, name=type(child).__name__):
                seen.append((name, imgs.shape[0]))
                return orig(g, imgs, masks)
            child.force_apply = spy
    imgs, masks = batch(seed=56, n=16, h=24, w=24)
    pipe.root.transforms[0].height = pipe.root.transforms[0].width = 24
    pipe(torch.Generator().manual_seed(0), imgs, masks)
    expected = []
    for t in jpipe.root.transforms[1:]:
        if isinstance(t, JT.OneOf):
            counts = JT._apportion(16, [float(w) for w in t.probs])
            expected += [(type(c).__name__, k)
                         for c, k in zip(t.transforms, counts)]
        elif t.p < 1:
            expected.append((type(t).__name__,
                             JT._apportion(16, [t.p, 1 - t.p])[0]))
        else:
            expected.append((type(t).__name__, 16))
    seen = [s for s in seen if s[0] != "Resize"]
    assert seen == [e for e in expected if e[0] != "ToTensorV2"]
    assert ("ISONoise", 2) in seen  # p = 0.1 at 16 gets 2 slots


# ---------------------------------------------------------- the pipeline

def pinned_kvasir_spec(size):
    spec = albu_yaml.load(PINNED_YAML)
    spec["transform"]["transforms"][0].update(height=size, width=size)
    return spec


def test_pinned_kvasir_pipeline_matches_jax():
    spec = pinned_kvasir_spec(64)
    imgs, masks = batch(seed=57, n=4, h=48, w=48)
    ref, ref_m = run_jax(spec, imgs, masks)
    out, out_m = run_port(spec, imgs, masks)
    assert out.shape == (4, 64, 64, 3) and out_m.dtype == np.int32
    np.testing.assert_allclose(out, ref, **NORM_TOL)
    assert_masks_equal(out_m, ref_m, rotate_angle=30.0)


def test_pipeline_takes_uint8_tensors_without_masks():
    spec = pinned_kvasir_spec(32)
    imgs, _ = batch(seed=58, n=2, h=32, w=32)
    out, om = Pipeline.from_dict(spec)(torch.Generator().manual_seed(0),
                                       torch.from_numpy(imgs))
    assert om is None and out.shape == (2, 3, 32, 32)
    assert out.dtype == torch.float32 and out.is_contiguous()
    assert Pipeline.from_dict(spec).output_shape((3, 48, 40)) == (3, 32, 32)


def test_kvasir_pipeline_runs_every_branch_at_full_batch():
    pipe = Pipeline.from_yaml(REPO / "configs/augmentation/"
                              "kvasir_train_transform.yaml")
    pipe.root.transforms[0].height = pipe.root.transforms[0].width = 32
    imgs, masks = batch(seed=59, n=16, h=32, w=32)
    out, om = pipe(torch.Generator().manual_seed(0), imgs, masks)
    assert out.shape == (16, 3, 32, 32) and om.shape == (16, 32, 32)
    assert bool(torch.isfinite(out).all())
    assert set(om.unique().tolist()) <= {0, 1, 2}
