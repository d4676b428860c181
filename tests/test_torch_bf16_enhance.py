"""The bf16 enhance driver of se_tpu_torch on the CPU, without JAX: which
families run in bf16 and which raise (DeepXi, naming se_tpu's fp32-only
decode), the bf16
copy of the caller's module (made once, kept until a weight changes, the
caller's fp32 weights untouched), the kernel packs' one entry a dtype
(`_cached`), Uformer's U-net tail vectors folded in fp32 from bf16 values,
Uformer's bf16 train forward, and the STFT's dtypes (se_tpu's: the forward
rounds to its input's dtype, the inverse returns fp32)."""

import numpy as np
import pytest
import torch

from se_tpu_torch.eval import enhance as drv
from se_tpu_torch.models import available_models, get_model
from se_tpu_torch.models import uformer as uf
from se_tpu_torch.nn import LSTM
from se_tpu_torch.ops.stft import PRESET_UFORMER, istft, stft
from se_tpu_torch.train import trainer

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(n=3200, seed=0):
    return (np.random.default_rng(seed).standard_normal((1, n)) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize(
    "name", [n for n in available_models() if not get_model(n).bf16])
def test_other_families_raise_on_bf16_naming_the_item(name):
    """Before any work: the model is not even looked at. Only DeepXi is
    left: se_tpu's DeepXi decode takes no dtype."""
    with pytest.raises(NotImplementedError, match="deepxi.py:611"):
        drv.enhance_waveform(name, None, _wav(), device="cpu",
                             dtype=BF16)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        drv.enhance_waveform("uformer", None, _wav(), device="cpu",
                             dtype=dtype)


def test_fp32_dtype_is_the_fp32_path():
    model = get_model("ctsnet").make(device="cpu")
    wav = _wav()
    want = drv.enhance_waveform("ctsnet", model, wav, device="cpu")
    got = drv.enhance_waveform("ctsnet", model, wav, device="cpu",
                               dtype=torch.float32)
    np.testing.assert_array_equal(got, want)
    assert "_bf16_copy" not in model.__dict__


def test_bf16_copy_is_made_once_and_kept_until_a_weight_changes():
    model = get_model("ctsnet").make(device="cpu")
    wav = _wav()
    first = drv.enhance_waveform("ctsnet", model, wav, device="cpu",
                                 dtype=BF16)
    twin = model.__dict__["_bf16_copy"][1]
    assert drv.enhance_waveform("ctsnet", model, wav, device="cpu",
                                dtype=BF16) is not None
    assert model.__dict__["_bf16_copy"][1] is twin  # kept
    # the complex-spectrum families keep the rounded weights in fp32
    for p, q in zip(model.parameters(), twin.parameters()):
        assert p.dtype == q.dtype == torch.float32
        assert torch.equal(q, p.to(BF16).float())
    with torch.no_grad():
        next(model.parameters()).mul_(1.5)
    again = drv.enhance_waveform("ctsnet", model, wav, device="cpu",
                                 dtype=BF16)
    assert model.__dict__["_bf16_copy"][1] is not twin  # made anew
    assert not np.array_equal(again, first)


@pytest.mark.parametrize("name,rest", [("gcrn", torch.float32),
                                       ("dccrn", torch.float32),
                                       ("crn", BF16), ("fullsubnet", BF16)])
def test_bf16_copy_keeps_every_lstm_in_bf16(name, rest):
    """An LSTM's weights stay bf16 in every family's copy (they pick the
    LSTM kernels' bf16 variants); the other weights are kept in the input's
    dtype: fp32 for a complex spectrum, bf16 for a magnitude."""
    kw = dict(fb_hidden=16, sb_hidden=8) if name == "fullsubnet" else \
        dict(kernel_num=(8, 8, 8, 8, 8, 8), rnn_units=16) \
        if name == "dccrn" else {}
    model = get_model(name).make(device="cpu", **kw)
    twin = drv.bf16_model(get_model(name), model)
    lstm_params = {id(p) for m in twin.modules() if isinstance(m, LSTM)
                   for p in list(m.parameters()) + list(m.buffers())}
    assert lstm_params
    for p in list(twin.parameters()) + list(twin.buffers()):
        assert p.dtype == (BF16 if id(p) in lstm_params else rest)
    for p, q in zip(model.parameters(), twin.parameters()):
        assert p.dtype == torch.float32
        assert torch.equal(q.float(), p.to(BF16).float())


def _uformer():
    gen = torch.Generator().manual_seed(3)
    model = uf.Uformer(device="cpu", generator=gen)
    with torch.no_grad():  # BN statistics off their defaults
        for mod in model.modules():
            if isinstance(mod, uf.BatchNorm):
                c = mod.running_var.shape[0]
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    return model


def test_uformer_caches_one_entry_a_dtype_and_keeps_fp32_weights():
    model = _uformer()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    wav = _wav(1600)
    drv.enhance_waveform("uformer", model, wav, device="cpu")
    drv.enhance_waveform("uformer", model, wav, device="cpu", dtype=BF16)
    twin = model.__dict__["_bf16_copy"][1]
    for k, v in model.state_dict().items():  # the caller's fp32, as it was
        assert v.dtype == before[k].dtype and torch.equal(v, before[k])
    assert all(p.dtype == BF16 for p in twin.parameters())
    fp32_slots = set(model.__dict__["_weight_cache"])
    bf16_slots = set(twin.__dict__["_weight_cache"])
    assert ("encoder", 0, torch.float32) in fp32_slots
    assert ("encoder", 0, BF16) in bf16_slots
    assert not any(s[2] == BF16 for s in fp32_slots)
    assert not any(s[2] == torch.float32 for s in bf16_slots)
    # a weight changed in place invalidates both
    fp32_entry = model._encoder_weights(0)
    with torch.no_grad():
        model.encoder[0][0].real_conv.weight.mul_(2.0)
    assert model._encoder_weights(0) is not fp32_entry
    drv.enhance_waveform("uformer", model, wav, device="cpu", dtype=BF16)
    assert model.__dict__["_bf16_copy"][1] is not twin


def test_cached_entries_of_two_dtypes_never_serve_each_other():
    mod = torch.nn.Linear(3, 2)
    owner = torch.nn.Module()
    made = []

    def make():
        made.append(next(mod.parameters()).dtype)
        return len(made)

    with torch.no_grad():
        assert uf._cached(owner, "k", 0, (mod,), make) == 1
        assert uf._cached(owner, "k", 0, (mod,), make) == 1
        mod.to(BF16)
        assert uf._cached(owner, "k", 0, (mod,), make) == 2
        mod.float()  # new storages: the old fp32 entry no longer holds
        assert uf._cached(owner, "k", 0, (mod,), make) == 3
    assert made == [torch.float32, BF16, torch.float32]
    assert {slot[2] for slot in owner.__dict__["_weight_cache"]} == {
        torch.float32, BF16}


def test_uformer_level_tails_fold_in_fp32_from_bf16_values():
    model = _uformer()
    twin = drv.bf16_model(get_model("uformer"), model)
    params, _ = twin._encoder_weights(2)
    w, bias, inv, shift, alpha = params[:5]
    assert w.dtype == BF16
    assert all(t.dtype == torch.float32 for t in (bias, inv, shift, alpha))
    bn = twin.encoder[2][1]
    var, g = bn.running_var.float(), bn.weight.float()
    want_inv = torch.rsqrt(var + bn.eps) * g
    torch.testing.assert_close(inv[0], want_inv.repeat(2), rtol=0, atol=0)
    want_shift = bn.bias.float() - bn.running_mean.float() * want_inv
    torch.testing.assert_close(shift[0], want_shift.repeat(2), rtol=0,
                               atol=0)


def test_uformer_bf16_train_forward_runs():
    """Uformer's train mode runs a bf16 forward (its levels and DSConv
    blocks on the plain path, in bf16) with gradients back to bf16 weights
    (tests/test_torch_bf16_train_conv.py holds the step against
    se_tpu's)."""
    model = _uformer().train().to(BF16)
    x = torch.from_numpy(_wav(1600)).to(BF16)
    est, _, (re, im), _ = model(x, x, generator=torch.Generator())
    assert re.dtype == BF16 and est.dtype == torch.float32  # the iSTFT's
    assert bool(torch.isfinite(est).all())
    (est.float().square().sum() + re.float().sum()).backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and g.dtype == BF16 for g in grads)


def test_uformer_trains_in_fp32_only():
    """The weights Uformer trains are fp32 only: the bf16 train contract
    (`trainer._bf16_call`) runs its train forward on bf16 casts made
    inside the graph, and its own parameters, their gradients and its
    buffers stay fp32, the outputs widened to fp32."""
    model = _uformer().train()
    x = torch.from_numpy(_wav(1600))
    est, _, (re, _), _ = trainer._bf16_call(model, x, x,
                                            generator=torch.Generator())
    assert est.dtype == re.dtype == torch.float32
    (est.square().sum() + re.sum()).backward()
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in model.buffers()
               if b.is_floating_point())


def test_stft_dtypes_follow_se_tpu():
    """bf16 in: the forward's products summed in fp32 and rounded to bf16;
    the inverse's frames, overlap-add and samples fp32."""
    x = torch.from_numpy(_wav(1600)).to(BF16)
    re, im = stft(x, PRESET_UFORMER)
    assert re.dtype == im.dtype == BF16
    want_re, want_im = stft(x.float(), PRESET_UFORMER)
    # the basis rounded to bf16, the products exact, sums fp32, one rounding
    basis_err = float((re.float() - want_re).abs().max())
    assert basis_err <= 2 ** -7 * float(want_re.abs().max())
    out = istft(re, im, PRESET_UFORMER, length=1600)
    assert out.dtype == torch.float32
    assert torch.isfinite(out).all()
