"""The work a training step needs, from layer shapes, and the chip's peaks.

Operations count a multiply-add as two. Per pass over a chunk of ``b``
images every convolution and the linear layer run forward, take the
gradient of their weights, and pass the gradient to their input, except the
first convolution, whose input is the image. The layers are the model
family's (:func:`.cells.family`). A forward-difference gradient penalty
runs a second such pass a chunk. Bytes count each operand read once and
each result written once: a convolution's input, weight and output; a
train-mode BatchNorm's forward reads ``x`` and writes ``y``, its backward
reads ``x`` and ``dy`` and writes ``dx``.
"""

from __future__ import annotations

from .cells import family

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def compute_dtype(recipe: dict) -> str:
    """The dtype convolutions run in: ``impl.compute_dtype``, else bfloat16
    under ``impl.mixed_precision``, else float32."""
    if recipe.get("impl.compute_dtype"):
        return str(recipe["impl.compute_dtype"])
    return "bfloat16" if recipe.get("impl.mixed_precision") else "float32"


def model_layers(config: dict):
    """Every layer of ``config``'s model in order, flat."""
    reference = family(config)
    return reference.layers(reference.architecture(config))


def forward_macs(config: dict) -> int:
    """Multiply-adds of one image's forward through the convolutions and the
    linear layer."""
    total = 0
    for layer in model_layers(config):
        if layer[0] == "conv":
            _, _, cin, cout, k, stride, h = layer
            total += cout * cin * k * k * (h // stride) ** 2
        elif layer[0] == "fc":
            total += layer[2] * layer[3]
    return total


def layout(config: dict, recipe: dict) -> tuple[int, int]:
    """``(chunks a step, images a chunk)``: whole blocks of ``batch_size``
    in chunks of ``sub_batch``."""
    batch, sub = int(recipe["data.batch_size"]), int(recipe["hyp.sub_batch"])
    return (int(config["data.size"]) // batch) * (batch // sub), sub


def passes(recipe: dict) -> int:
    """Forward and backward passes a chunk: two under a forward-difference
    gradient penalty."""
    return 2 if float(recipe.get("hyp.grad_reg.block_strength", 0) or 0) else 1


def step_work(config: dict, recipe: dict) -> dict:
    """``images``, ``model_flops``, ``conv_flops``, ``conv_min_s``,
    ``bn_bytes`` and ``bn_min_s`` of one step, and the ``peak_flops`` of its
    compute dtype."""
    dtype = compute_dtype(recipe)
    peak, item = PEAK_FLOPS[dtype], ITEMSIZE[dtype]
    chunks, b = layout(config, recipe)
    conv_flops = conv_min = fc_flops = bn_bytes = 0.0
    first = True
    for layer in model_layers(config):
        if layer[0] == "conv":
            _, _, cin, cout, k, stride, h = layer
            h_out = h // stride
            x, w, y = b * cin * h * h, cout * cin * k * k, b * cout * h_out * h_out
            flops = 2.0 * w * b * h_out * h_out
            ops = [(flops, x + w + y), (flops, x + y + w)]      # forward, weight gradient
            if not first:
                ops.append((flops, y + w + x))                # input gradient
            first = False
            for f, nbytes in ops:
                conv_flops += f
                conv_min += max(f / peak, nbytes * item / HBM_BYTES_PER_S)
        elif layer[0] == "bn":
            _, _, c, h = layer
            bn_bytes += 5.0 * b * h * h * c * item
        elif layer[0] == "fc":
            fc_flops += 3 * 2.0 * b * layer[2] * layer[3]
    scale = chunks * passes(recipe)
    return {"images": chunks * b, "dtype": dtype, "peak_flops": peak,
            "model_flops": scale * (conv_flops + fc_flops), "conv_flops": scale * conv_flops,
            "conv_min_s": scale * conv_min, "bn_bytes": scale * bn_bytes,
            "bn_min_s": scale * bn_bytes / HBM_BYTES_PER_S}
