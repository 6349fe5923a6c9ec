"""The port's train-mode numerics against the JAX package's, on the CPU,
at ir_micro: the semantics in float64, the optimizer, bf16, the int8-forward
conv and the fused int8 body.

* `test_train_forward_backward_matches_jax_in_float64`: the train-mode
  forward (batch statistics with the biased variance, dropout with a given
  mask, the float32 cast before the norm) and its gradients, both packages
  in float64 from the same variables: loss within 1e-6 relative, every
  gradient leaf within 1e-5 of its norm, flax's running-stat update from
  the port's batch statistics within 1e-6. Only the float32 tail (the cast
  before the norm, which both packages make) keeps this above float64's
  rounding; an unbiased variance would be off by 1/3 at B=4.
* the fused update against the unfused optax-style chain: bit for bit;
* bf16 compute held loosely to float32: loss within 2e-2, gradient cosine
  >= 0.99;
* the int8-forward conv: codes equal but for counted off-by-one flips
  (a float32 quotient on a rounding boundary), s32 sums exactly those of
  XLA's int8 conv on the same codes, the output within those flips, and the
  gradients the float conv's VJP (1e-4 relative to JAX's, 1e-5 to the
  port's own float conv, whose backward takes another CPU path);
* the fused int8 body: `fuse_quantized_params` bit for bit, embeddings
  within cosine 0.999 of the JAX `FusedQuantBody`'s and 0.9999 of the
  port's unfused int8 backbone.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models import irse as jirse
from facerecognitionpipeline_tpu.models import quantize as jq
from facerecognitionpipeline_tpu.models.fold import fold_inference_variables as jax_fold
from facerecognitionpipeline_tpu.ops.image import preprocess_faces as jax_preprocess
from facerecognitionpipeline_tpu_torch.models import irse as tirse
from facerecognitionpipeline_tpu_torch.models import quantize as tq
from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_state_from_jax,
    backbone_variables_from_state,
    fused_body_state_from_jax,
)
from facerecognitionpipeline_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    dropout_generator,
)

torch.set_num_threads(2)

BASE = dict(architecture="ir_micro", num_classes=64, learning_rate=0.05)
KEY = jax.random.PRNGKey(0)
_rng = np.random.default_rng(0)
X = _rng.uniform(-1, 1, (4, 112, 112, 3)).astype(np.float32)
Y = _rng.integers(0, 64, 4).astype(np.int32)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _capture(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.module.name == "output_dropout" and context.method_name == "__call__":
            jax.debug.callback(lambda v: masks.append(np.asarray(v) != 0), out)
        return out
    return interceptor


@pytest.fixture(scope="module")
def variables():
    """Unfolded ir_micro variables in the JAX layout, from the port's
    flax-like init with a little spread in the BatchNorm statistics."""
    state = Trainer(TrainConfig(**BASE), device="cpu").init_state(3)
    v = backbone_variables_from_state({**state["params"]["backbone"], **state["batch_stats"]})
    rng = np.random.default_rng(4)

    def spread(node):
        if "mean" in node:
            node["mean"] = rng.normal(0, 0.1, node["mean"].shape).astype(np.float32)
            node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(np.float32)
        else:
            for sub in node.values():
                spread(sub)

    spread(v["batch_stats"])
    return v


def test_train_forward_backward_matches_jax_in_float64(variables):
    """The train-mode forward (batch statistics, dropout, biased variance,
    the float32 cast before the norm) and its gradients, both packages in
    float64 from the same variables and mask: the semantics, free of
    float32's conditioning."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (4, 112, 112, 3))
    r = rng.standard_normal((4, 512))
    v = variables
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        model = jirse.build_backbone("ir_micro", dtype=jnp.float64)
        masks = []

        def loss(p):
            (f, n), upd = model.apply({"params": p, "batch_stats": v64["batch_stats"]}, x,
                                      train=True, rngs={"dropout": KEY},
                                      mutable=["batch_stats"])
            return jnp.sum(f * r) + 0.01 * jnp.sum(n), upd

        with nn.intercept_methods(_capture(masks)):
            (jl, upd), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(v64["params"])
            jax.effects_barrier()
        jg, jl, upd = jax.device_get((jg, jl, upd))
    mask = torch.from_numpy(masks[0]).permute(0, 3, 1, 2)
    m = tirse.build_backbone("ir_micro")
    m.load_state_dict(backbone_state_from_jax(v, folded=False))
    m = m.double()
    stats = {}
    f, n = m(torch.from_numpy(x), train=True, dtype=torch.float64, dropout_mask=mask,
             stats=stats)
    assert f.dtype == n.dtype == torch.float32
    tl = (f.double() * torch.from_numpy(r)).sum() + 0.01 * n.double().sum()
    tl.backward()
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    sd = {k: p.grad for k, p in m.named_parameters()}
    got = _flat(backbone_variables_from_state(
        {**sd, **{k: b for k, b in m.named_buffers() if "running" in k}})["params"])
    want = _flat(jg)
    for k in want:
        assert np.linalg.norm(got[k] - want[k]) <= 1e-5 * (np.linalg.norm(want[k]) + 1e-6), k
    # flax's running update from the same batch statistics
    new = _flat(upd["batch_stats"])
    for name, (mean, var) in stats.items():
        key = "['" + "']['".join(name.split(".")) + "']"
        np.testing.assert_allclose(0.9 * _flat(v["batch_stats"])[key + "['mean']"]
                                   + 0.1 * mean.numpy(), new[key + "['mean']"], rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(0.9 * _flat(v["batch_stats"])[key + "['var']"]
                                   + 0.1 * var.numpy(), new[key + "['var']"], rtol=1e-6)



def test_fused_update_equals_the_unfused_chain_bit_for_bit():
    """As the JAX package's test_fused_optimizer_matches_optax: the same
    trajectory, here bit for bit (one order of operations on both sides)."""
    runs = {}
    for fused in (True, False):
        t = Trainer(TrainConfig(**BASE, lr_schedule="step", total_steps=10, warmup_steps=2,
                                fused_optimizer=fused), device="cpu")
        state = t.init_state(0)
        for i in range(3):
            state, _ = t.train_step(state, X, Y, dropout_generator(0, i))
        runs[fused] = (t, state)
    sf, so = runs[True][1], runs[False][1]
    assert isinstance(sf["opt_state"], dict) and isinstance(so["opt_state"], tuple)
    assert int(sf["opt_state"]["count"]) == int(so["opt_state"][1][1]["count"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(_torch_tree(sf["params"])),
                    jax.tree_util.tree_leaves(_torch_tree(so["params"]))):
        assert np.array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(_torch_tree(sf["opt_state"]["trace"])),
                    jax.tree_util.tree_leaves(_torch_tree(so["opt_state"][1][0]["trace"]))):
        assert np.array_equal(a, b)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()



def test_bf16_step_held_loosely_to_float32():
    """bf16 compute with float32 parameters: same state and mask, the loss
    within 2e-2 relative and the gradient's direction within cosine 0.99 of
    the float32 step's; parameters stay float32."""
    mask = torch.rand((4, 512, 7, 7), generator=torch.Generator().manual_seed(1)) < 0.6
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        t = Trainer(TrainConfig(**BASE, loss="adaface", dtype=dt), device="cpu")
        s = t.init_state(0)
        loss, aux, g = t.loss_and_grads(s, X, Y, dropout_mask=mask)
        out[dt] = (float(loss), np.concatenate([v.float().numpy().ravel()
                                                for v in [*g["backbone"].values(),
                                                          g["classifier"]]]))
        s, _ = t.train_step(s, X, Y, dropout_mask=mask)
        assert all(p.dtype == torch.float32 for p in s["params"]["backbone"].values())
    (l32, g32), (l16, g16) = out[torch.float32], out[torch.bfloat16]
    assert l16 == pytest.approx(l32, rel=2e-2)
    assert g16 @ g32 / np.linalg.norm(g16) / np.linalg.norm(g32) >= 0.99



# ------------------------------------------------------- int8-forward conv


def _jax_codes(x, w):
    """The JAX package's int8_fwd_conv quantization, in its own lines."""
    ax = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12) / 127.0
    aw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12) / 127.0
    xq = jnp.clip(jnp.round(x / ax), -127, 127).astype(jnp.int8)
    wq = jnp.clip(jnp.round(w / aw), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(wq), float(ax), np.asarray(aw)


@pytest.mark.parametrize("b,h,cin,cout,stride", [
    (2, 16, 16, 24, 1), (2, 15, 8, 16, 2), (3, 14, 64, 64, 2), (2, 28, 64, 128, 1),
])
def test_int8_forward_conv_matches_jax(b, h, cin, cout, stride):
    """Codes equal but for counted off-by-one flips (a float32 quotient on
    a rounding boundary), s32 sums equal exactly given equal codes, the
    output within those flips, and the gradients equal to the float conv's
    VJP on the unquantized operands."""
    rng = np.random.default_rng(b * h + cin)
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_()

    jxq, jwq, jax_ax, jaw = _jax_codes(x, w)
    xq, wq, ax, aw = tirse.int8_forward_codes(xt.detach(), wt.detach())
    assert ax.item() == np.float32(jax_ax) and np.array_equal(aw.numpy(), jaw)
    flips = int((xq.numpy().astype(int) != jxq).sum()) + int(
        (wq.permute(2, 3, 1, 0).numpy().astype(int) != jwq).sum())
    assert np.abs(xq.numpy().astype(int) - jxq).max() <= 1
    assert flips <= max(2, xq.numel() // 10_000)

    sums = tirse.int8_forward_sums(xq, wq, stride, 1)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq.numpy()), jnp.asarray(wq.permute(2, 3, 1, 0).numpy()), (stride, stride),
        [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    assert np.array_equal(sums.numpy(), np.asarray(want))

    y = tirse._Int8FwdConvFn.apply(xt, wt, stride, 1)
    jy, vjp = jax.vjp(lambda a, k: jirse.int8_fwd_conv(a, k, stride, 1), x, w)
    step = float(jax_ax) * float(jaw.max()) * 127
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               rtol=1e-6, atol=flips * step + 1e-6)
    g = rng.standard_normal(jy.shape).astype(np.float32)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    jgx, jgw = vjp(g)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(jgw),
                               rtol=1e-4, atol=1e-4)
    xf, wf = xt.detach().clone().requires_grad_(), wt.detach().clone().requires_grad_()
    torch.nn.functional.conv2d(xf, wf, None, stride, 1).backward(
        torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.numpy(), xf.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), wf.grad.numpy(), rtol=1e-5, atol=1e-5)


def test_int8_forward_backbone_declares_the_float_parameters():
    """Int8FwdConv carries the nn.Conv2d's `weight`: state dicts (and so
    checkpoints and exports) are interchangeable; a train step runs, with a
    loss near the float step's from the same state and mask."""
    plain = tirse.build_backbone("ir_micro")
    int8 = tirse.build_backbone("ir_micro", int8_fwd_train=True)
    assert plain.state_dict().keys() == int8.state_dict().keys()
    assert isinstance(int8.stage1_unit0.res_conv2, tirse.Int8FwdConv)
    mask = torch.rand((4, 512, 7, 7), generator=torch.Generator().manual_seed(2)) < 0.6
    losses = []
    for flag in (False, True):
        t = Trainer(TrainConfig(**BASE, loss="cosface", int8_forward=flag), device="cpu")
        s = t.init_state(0)
        s, m = t.train_step(s, X, Y, dropout_mask=mask)
        losses.append(float(m["loss"]))
        assert all(torch.isfinite(p).all() for p in s["params"]["backbone"].values())
    assert losses[1] == pytest.approx(losses[0], rel=5e-2)


# --------------------------------------------------------- fused int8 body


@pytest.fixture(scope="module")
def quantized_micro(variables):
    folded = jax.device_get(jax_fold(variables))
    faces = tq.default_calibration_faces(8, seed=3)
    amax = jq.calibrate_activation_amax(jirse.build_backbone("ir_micro", folded=True), folded,
                                        jax_preprocess(jnp.asarray(faces)))
    return folded, jax.device_get(jq.quantize_folded_variables(folded, amax))


def test_fuse_quantized_params_bit_equal_to_jax(quantized_micro):
    _, qvars = quantized_micro
    ours = tq.fuse_quantized_params(qvars)
    flat = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(ours)}
    raw = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(jq.fuse_quantized_params(qvars))}
    assert flat.keys() == raw.keys()
    for k in flat:
        assert flat[k].dtype == raw[k].dtype and flat[k].tobytes() == raw[k].tobytes(), k


def test_fused_int8_body_matches_jax(quantized_micro):
    """The fused backbone from the same fused variables: embeddings within
    1e-6 of the JAX FusedQuantBody's, in cosine distance and per element
    (measured 1.2e-7 and 1.5e-7: with bit-equal constants and exact s32
    sums no code flips here, and only the float layers around the bodies
    round differently; one wrong constant moves an embedding by far more),
    and within 0.9999 of the port's unfused int8 backbone (the JAX
    package's fused-vs-unfused bound; measured 1.8e-5)."""
    _, qvars = quantized_micro
    fvars = jax.device_get(jq.fuse_quantized_params(qvars))
    x = np.random.default_rng(7).uniform(-1, 1, (4, 112, 112, 3)).astype(np.float32)
    jf, _ = jirse.build_backbone("ir_micro", folded=True, quantized=True,
                                 fused_int8=True).apply(fvars, x)
    fused = tirse.build_backbone("ir_micro", folded=True, quantized=True, fused_int8=True)
    fused.load_state_dict(fused_body_state_from_jax(fvars))
    unfused = tirse.build_backbone("ir_micro", folded=True, quantized=True)
    unfused.load_state_dict(backbone_state_from_jax(qvars, folded=True))
    with torch.no_grad():
        tf, _ = fused.eval()(torch.from_numpy(x))
        uf, _ = unfused.eval()(torch.from_numpy(x))
    cos = lambda a, b: np.sum(a * b, axis=1)  # noqa: E731
    assert cos(tf.numpy(), np.asarray(jf)).min() >= 1 - 1e-6
    assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 1e-6
    assert cos(tf.numpy(), uf.numpy()).min() > 0.9999
    body = fused.stage1_unit0.body.to(torch.bfloat16)
    assert body.qscale.dtype == body.out_bias.dtype == torch.float32
    assert body.gemm_w1.dtype == torch.int8
    with pytest.raises(ValueError, match="quantized"):
        tirse.build_backbone("ir_micro", folded=True, fused_int8=True)
