"""Policy augmentations (RandAugment / AutoAugment / AugMix), on the host.

The port's own copy of ``fullbatchtraining_tpu/data/policy_augment.py``
(that module imports no JAX, but the port imports nothing of the JAX
package). It re-implements the policy transforms that the upstream
fullbatchtraining repository vendored from timm (``auto_augment.py``,
Apache-2.0, used for the config keys
``data.db.augmentations_train.{RandAugment,AutoAugment,AugMix}`` with timm
spec strings like ``rand-m7-n2-mstd0.5-inc1``). "reference :N" below names
a line of that upstream file.

Every op (incl. the ``TranslateXRel/YRel`` relative translations and the
``*Increasing`` family selected by ``-inc1`` specs) consumes draws from
``random`` / ``np.random`` in the upstream order, and this copy keeps the
JAX package's code line for line, so one seed gives byte-identical images in
both packages (``tests/test_torch_baked.py``).

Deviations from upstream, the same as the JAX package's: a ``-inc0`` spec
selects the plain op set (upstream's ``bool(str(val))`` treats any digit,
even 0, as true), and AugMix ``-b0`` means basic mixing for the same reason.
``-w0`` weights are looked up by the default op-name list and applied
positionally, as upstream's _select_rand_weights does, so ``-inc1-w0``
composes. The AutoAugment policy tables (v0/v0r/original/originalr) are the
published policy constants (arXiv:1805.09501 and the TF TPU EfficientNet
repo).

These are PIL per-image transforms, so they run when a store is baked
(``data/baked.py``); crop and flip run on the device.
"""

from __future__ import annotations

import random
import re
from typing import Callable

import numpy as np

try:
    from PIL import Image, ImageEnhance, ImageOps
except ImportError as _err:  # soft dependency: only policy recipes need it
    raise ImportError(
        "Policy augmentations (AutoAugment/RandAugment/AugMix) render "
        "through Pillow, which is not installed. "
        "Install pillow to bake a store with a policy augmentation."
    ) from _err

_MAX_LEVEL = 10.0
_FILL = (128, 128, 128)
# Geometric ops draw their interpolation per call (reference :247-255).
_RANDOM_INTERPOLATION = (Image.BILINEAR, Image.BICUBIC)

_ENHANCE = {"Color": ImageEnhance.Color, "Contrast": ImageEnhance.Contrast,
            "Brightness": ImageEnhance.Brightness, "Sharpness": ImageEnhance.Sharpness}


def _negate(value):
    # reference :382-384: negate when random.random() > 0.5
    return -value if random.random() > 0.5 else value


def _level_args(name: str, level: float, hparams: dict) -> tuple:
    """Magnitude level in [0, 10] -> op arguments (reference :387-483)."""
    frac = level / _MAX_LEVEL
    if name == "Rotate":
        return (_negate(frac * 30.0),)
    if name in ("ShearX", "ShearY"):
        return (_negate(frac * 0.3),)
    if name in ("TranslateX", "TranslateY"):
        return (_negate(frac * float(hparams["translate_const"])),)
    if name in ("TranslateXRel", "TranslateYRel"):
        return (_negate(frac * hparams.get("translate_pct", 0.45)),)
    if name == "Posterize":
        return (int(frac * 4),)
    if name == "PosterizeIncreasing":
        return (4 - int(frac * 4),)
    if name == "PosterizeOriginal":
        return (int(frac * 4) + 4,)
    if name == "Solarize":
        return (int(frac * 256),)
    if name == "SolarizeIncreasing":
        return (256 - int(frac * 256),)
    if name == "SolarizeAdd":
        return (int(frac * 110),)
    if name.removesuffix("Increasing") in _ENHANCE:
        if name.endswith("Increasing"):
            # 'no change' is 1.0; severity grows with distance from it (:398-403)
            return (max(0.1, 1.0 + _negate(frac * 0.9)),)
        return (frac * 1.8 + 0.1,)
    return ()  # AutoContrast / Equalize / Invert take no magnitude


def _solarize_add(img, add, thresh=128):
    if img.mode not in ("L", "RGB"):
        return img
    lut = [min(255, i + add) if i < thresh else i for i in range(256)]
    return img.point(lut * (3 if img.mode == "RGB" else 1))


def _apply_op(name: str, img: Image.Image, args: tuple, fill) -> Image.Image:
    """Apply one named op. Geometric ops consume one interpolation draw
    (reference _check_args_tf :257-260)."""
    if name == "AutoContrast":
        return ImageOps.autocontrast(img)
    if name == "Equalize":
        return ImageOps.equalize(img)
    if name == "Invert":
        return ImageOps.invert(img)
    base = name.removesuffix("Increasing")
    if base in _ENHANCE:
        return _ENHANCE[base](img).enhance(args[0])
    if name.startswith("Posterize"):
        return img if args[0] >= 8 else ImageOps.posterize(img, args[0])
    if name in ("Solarize", "SolarizeIncreasing"):
        return ImageOps.solarize(img, args[0])
    if name == "SolarizeAdd":
        return _solarize_add(img, args[0])
    resample = random.choice(_RANDOM_INTERPOLATION)
    if name == "Rotate":
        return img.rotate(args[0], resample=resample, fillcolor=fill)
    matrix = {
        "ShearX": (1, args[0], 0, 0, 1, 0),
        "ShearY": (1, 0, 0, args[0], 1, 0),
        "TranslateX": (1, 0, args[0], 0, 1, 0),
        "TranslateY": (1, 0, 0, 0, 1, args[0]),
        "TranslateXRel": (1, 0, args[0] * img.size[0], 0, 1, 0),
        "TranslateYRel": (1, 0, 0, 0, 1, args[0] * img.size[1]),
    }[name]
    return img.transform(img.size, Image.AFFINE, matrix,
                         resample=resample, fillcolor=fill)


class _AugmentOp:
    """One (name, prob, magnitude) policy element (reference AugmentOp :517-560)."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 hparams: dict | None = None):
        self.name = name
        self.prob = prob
        self.magnitude = magnitude
        self.hparams = dict(hparams or {})
        self.fill = self.hparams.get("img_mean", _FILL)
        self.magnitude_std = self.hparams.get("magnitude_std", 0)
        self.magnitude_max = self.hparams.get("magnitude_max", None)

    def __call__(self, img: Image.Image) -> Image.Image:
        if self.prob < 1.0 and random.random() > self.prob:
            return img
        magnitude = self.magnitude
        if self.magnitude_std > 0:
            if self.magnitude_std == float("inf"):
                magnitude = random.uniform(0, magnitude)
            else:
                magnitude = random.gauss(magnitude, self.magnitude_std)
        magnitude = max(0.0, min(magnitude, self.magnitude_max or _MAX_LEVEL))
        args = _level_args(self.name, magnitude, self.hparams)
        return _apply_op(self.name, img, args, self.fill)


# Default RandAugment transform lists (reference :753-787). Note the
# relative translations in both, and Solarize/Posterize flipping to the
# Increasing variants under -inc1.
_RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]
_RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]
# Experimental op-choice weights for -w0 specs (reference :790-807).
_RAND_CHOICE_WEIGHTS_0 = {
    "Rotate": 0.3, "ShearX": 0.2, "ShearY": 0.2,
    "TranslateXRel": 0.1, "TranslateYRel": 0.1,
    "Color": 0.025, "Sharpness": 0.025, "AutoContrast": 0.025,
    "Solarize": 0.005, "SolarizeAdd": 0.005, "Contrast": 0.005,
    "Brightness": 0.005, "Equalize": 0.005, "Posterize": 0, "Invert": 0,
}


def _split_spec(section: str):
    parts = re.split(r"(\d.*)", section)
    return parts[:2] if len(parts) >= 2 else (None, None)


class _RandAugment:
    def __init__(self, ops, num_layers=2, choice_weights=None):
        self.ops, self.num_layers, self.choice_weights = ops, num_layers, choice_weights

    def __call__(self, img):
        # np.random (not random), no replacement under weighted choice (:818-825)
        chosen = np.random.choice(self.ops, self.num_layers,
                                  replace=self.choice_weights is None,
                                  p=self.choice_weights)
        for op in chosen:
            img = op(img)
        return img


def rand_augment_transform(spec: str, hparams: dict) -> Callable:
    """RandAugment from a timm spec string (reference :828-875)."""
    magnitude, num_layers, weight_idx = _MAX_LEVEL, 2, None
    transforms = _RAND_TRANSFORMS
    sections = str(spec).split("-")
    assert sections[0] == "rand", f"not a RandAugment spec: {spec}"
    for section in sections[1:]:
        key, val = _split_spec(section)
        if key is None:
            continue
        if key == "mstd":
            mstd = float(val)
            hparams.setdefault("magnitude_std",
                               float("inf") if mstd > 100 else mstd)
        elif key == "mmax":
            hparams.setdefault("magnitude_max", int(val))
        elif key == "inc":
            # timm quirk: any digit (even 0) enables Increasing via bool(str);
            # fixed here to respect the value (documented deviation).
            if int(val):
                transforms = _RAND_INCREASING_TRANSFORMS
        elif key == "m":
            magnitude = int(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            weight_idx = int(val)
        else:
            raise ValueError(f"Unknown RandAugment config section {section!r}")
    ops = [_AugmentOp(name, prob=0.5, magnitude=magnitude, hparams=hparams)
           for name in transforms]
    choice_weights = None
    if weight_idx is not None:
        assert weight_idx == 0
        # Reference _select_rand_weights is called WITHOUT the active
        # transform list (auto_augment.py:815-821, :900), so the weights are
        # always looked up by the DEFAULT op names and applied positionally —
        # this keeps -inc1 -w0 specs working (same list order/length).
        probs = np.array([_RAND_CHOICE_WEIGHTS_0[k] for k in _RAND_TRANSFORMS])
        choice_weights = probs / probs.sum()
    return _RandAugment(ops, num_layers, choice_weights)


# AutoAugment ImageNet policies: (op, prob, magnitude) pairs. v0 from the TF
# TPU EfficientNet repo, original from arXiv:1805.09501; the 'r' variants use
# PosterizeIncreasing (reference :563-698).
_AA_POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]
_AA_POLICY_ORIGINAL = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


def _aa_policy_table(name: str):
    if name in ("v0", "v0r"):
        table = _AA_POLICY_V0
    elif name in ("original", "originalr"):
        table = _AA_POLICY_ORIGINAL
    else:
        raise ValueError(f"Unknown AA policy {name!r}")
    if name.endswith("r"):  # research posterize variant
        swap = {"Posterize": "PosterizeIncreasing",
                "PosterizeOriginal": "PosterizeIncreasing"}
        table = [[(swap.get(op, op), p, m) for op, p, m in sub] for sub in table]
    return table


class _AutoAugment:
    def __init__(self, policy):
        self.policy = policy

    def __call__(self, img):
        for op in random.choice(self.policy):
            img = op(img)
        return img


def auto_augment_transform(spec: str, hparams: dict) -> Callable:
    """AutoAugment from a timm spec string like 'v0' or 'original-mstd0.5'
    (reference :727-751)."""
    sections = str(spec).split("-")
    policy_name = sections[0] or "v0"
    for section in sections[1:]:
        key, val = _split_spec(section)
        if key is None:
            continue  # digit-less section: reference skips it (:741-742)
        if key == "mstd":
            hparams.setdefault("magnitude_std", float(val))
        else:
            raise ValueError(f"Unknown AutoAugment config section {section!r}")
    policy = [[_AugmentOp(*args, hparams=hparams) for args in sub]
              for sub in _aa_policy_table(policy_name)]
    return _AutoAugment(policy)


_AUGMIX_TRANSFORMS = [
    "AutoContrast", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing", "Equalize", "Rotate",
    "PosterizeIncreasing", "SolarizeIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


class _AugMix:
    """AugMix (Hendrycks et al.): Dirichlet-weighted chains blended with the
    original via a Beta draw (reference :928-954)."""

    def __init__(self, ops, alpha=1.0, width=3, depth=-1, blended=False):
        self.ops, self.alpha, self.width, self.depth = ops, alpha, width, depth
        self.blended = blended

    def _chain(self, img):
        depth = self.depth if self.depth > 0 else np.random.randint(1, 4)
        for op in np.random.choice(self.ops, depth, replace=True):
            img = op(img)
        return img

    def __call__(self, img):
        ws = np.float32(np.random.dirichlet([self.alpha] * self.width))
        m = np.float32(np.random.beta(self.alpha, self.alpha))
        if self.blended:  # one PIL blend per chain (reference :901-925)
            cump, rws = 1.0, []
            for w in (ws * m)[::-1]:
                rws.append(w / cump)
                cump *= 1 - w / cump
            out = img
            for w in np.array(rws[::-1], np.float32):
                out = Image.blend(out, self._chain(img.copy()), w)
            return out
        mixed = np.zeros((*img.size[::-1], len(img.getbands())), np.float32)
        for w in ws:
            mixed += w * np.asarray(self._chain(img), np.float32)
        np.clip(mixed, 0, 255.0, out=mixed)
        return Image.blend(img, Image.fromarray(mixed.astype(np.uint8)), m)


def augment_and_mix_transform(spec: str, hparams: dict) -> Callable:
    """AugMix from a timm spec string like 'augmix-m5-w4-d2' (reference :956-1001)."""
    magnitude, width, depth, alpha, blended = 3, 3, -1, 1.0, False
    sections = str(spec).split("-")
    assert sections[0] == "augmix", f"not an AugMix spec: {spec}"
    for section in sections[1:]:
        key, val = _split_spec(section)
        if key is None:
            continue
        if key == "mstd":
            hparams.setdefault("magnitude_std", float(val))
        elif key == "m":
            magnitude = int(val)
        elif key == "w":
            width = int(val)
        elif key == "d":
            depth = int(val)
        elif key == "a":
            alpha = float(val)
        elif key == "b":
            # reference quirk fixed (documented in the module docstring):
            # bool(str(val)) made '-b0' enable blending; we respect the 0
            blended = bool(int(val))
        else:
            raise ValueError(f"Unknown AugMix config section {section!r}")
    hparams.setdefault("magnitude_std", float("inf"))  # uniform by default (:998)
    ops = [_AugmentOp(name, prob=1.0, magnitude=magnitude, hparams=hparams)
           for name in _AUGMIX_TRANSFORMS]
    return _AugMix(ops, alpha=alpha, width=width, depth=depth, blended=blended)


def get_policy_transform(key: str, spec: str, img_size: int, mean) -> Callable:
    """Dispatch matching the reference's _get_autoaugment
    (data_preparation.py:157-170)."""
    hparams = {
        "translate_const": int(img_size * 0.45),
        "img_mean": tuple(min(255, round(255 * x)) for x in mean),
    }
    # Dispatch on the SPEC prefix alone: the reference routes on the value
    # (data_preparation.py:157-170), so e.g. RandAugment: v0 builds an
    # AutoAugment transform; the config key is only the group name.
    spec = str(spec)
    if spec.startswith("rand"):
        return rand_augment_transform(spec, hparams)
    if spec.startswith("augmix"):
        hparams["translate_pct"] = 0.3
        return augment_and_mix_transform(spec, hparams)
    return auto_augment_transform(spec, hparams)


def apply_policy_batch(images: np.ndarray, key: str, spec: str, mean,
                       seed: int = 0, img_size: int | None = None) -> np.ndarray:
    """Apply a policy transform to a uint8 NHWC batch (bake-time path).

    ``img_size`` sets translate_const's base (the reference passes
    cfg_data.pixels, data_preparation.py:161); defaults to the batch's own
    H for callers without a data config."""
    random.seed(seed)
    np.random.seed(seed % 2**32)
    transform = get_policy_transform(key, spec, img_size or images.shape[1], mean)
    out = np.empty_like(images)
    for i in range(len(images)):
        out[i] = np.asarray(transform(Image.fromarray(images[i])), np.uint8)
    return out
