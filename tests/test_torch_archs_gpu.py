"""The program phase's row chunks and the MoE forward, on the card.

* The normal draw's counter offset: a slice of a draw on the card is
  bitwise the same slice drawn on the CPU.
* A member programmed in row chunks (``core/engine.py::_CHUNK``; the card
  needs them for an lm_head of 1.25 B weights) is bitwise the one-pass
  member on the card, and both bitwise the CPU's.
* A MoE LM (phi3.5-moe's smoke config in bf16, 4 experts) programmed on
  the card: a prefill and a decode step through B1's bank form -- one
  launch per family of each MoE layer -- against the same forward through
  the plain version (logits rel L2 < 5%, the same argmax).

Marked ``gpu``: each test skips on a host without a CUDA device. On the
card: ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_archs_gpu.py``. This file imports only the port.
"""

import dataclasses

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_normal_offset_on_card_is_the_cpu_slice(cuda):
    from repro_torch import prng

    key = prng.PRNGKey(5)
    card = prng.normal(key.to(cuda), (1000, 37), offset=123_456)
    assert torch.equal(card.cpu(), prng.normal(key, (1000, 37), offset=123_456))
    whole = prng.normal(key.to(cuda), (4000, 37))
    assert torch.equal(whole[1000:3000], prng.normal(key.to(cuda), (2000, 37), offset=37_000))


def test_chunked_member_is_the_one_pass_member(cuda, monkeypatch):
    from repro_torch import prng
    from repro_torch.core import engine, pcm

    w = prng.normal(prng.PRNGKey(1), (300, 700)) * 0.05
    lo, hi = torch.tensor(-0.1), torch.tensor(0.12)
    args = (prng.PRNGKey(2), w, lo, hi, 3600.0, pcm.PCMConfig())
    on = lambda a: tuple(t.to(cuda) if isinstance(t, torch.Tensor) else t for t in a)
    whole = engine.program_weight(*on(args))
    monkeypatch.setattr(engine, "_CHUNK", 50_000)  # 71-row chunks
    chunked = engine.program_weight(*on(args))
    cpu = engine.program_weight(*args)
    for a, b, c in zip(whole[:2], chunked[:2], cpu[:2]):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    for name in whole[2]:
        assert torch.equal(whole[2][name], chunked[2][name]), name
        assert torch.equal(whole[2][name].cpu(), cpu[2][name]), name


def test_moe_forward_through_the_bank_form(cuda):
    from repro_torch import prng
    from repro_torch.configs import get_smoke
    from repro_torch.core import engine
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.kernels import analog_mvm as kernel
    from repro_torch.models.lm import init_lm_cache, lm_forward, lm_init

    cfg = dataclasses.replace(get_smoke("phi3.5-moe-42b-a6.6b"), dtype=torch.bfloat16)
    params = lm_init(prng.PRNGKey(0), cfg, device=cuda)
    prog = engine.compile_program(params, AnalogConfig().infer(b_adc=8), prng.PRNGKey(1),
                                  device=cuda)
    p = engine.cast_weights(prog.params, cfg.dtype)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=torch.Generator().manual_seed(0))
    toks = toks.to(cuda)
    for s in (24, 1):  # a prefill, then a decode step from its cache
        cache = init_lm_cache(cfg, 2, 32, cfg.dtype, device=cuda)
        if s == 1:
            _, cache = lm_forward(p, {"tokens": toks[:, :23]}, prog.cfg, cfg, cache=cache)
        before = kernel.analog_mvm_bank.launches
        batch = {"tokens": toks[:, -s:] if s == 1 else toks}
        got, _ = lm_forward(p, batch, prog.cfg, cfg, cache=cache, last_token_only=True)
        torch.cuda.synchronize()
        assert kernel.analog_mvm_bank.launches - before == 3 * cfg.n_layers
        if s == 1:
            cache = init_lm_cache(cfg, 2, 32, cfg.dtype, device=cuda)
            _, cache = lm_forward(p, {"tokens": toks[:, :23]}, prog.cfg, cfg, cache=cache)
        want, _ = lm_forward(p, batch, prog.cfg, cfg, cache=cache, last_token_only=True,
                             mvm=engine.execute_mvm_plain)
        g, w = got[:, -1].float(), want[:, -1].float()
        assert float((g - w).norm() / w.norm()) < 0.05
        assert torch.equal(g.argmax(-1), w.argmax(-1))
