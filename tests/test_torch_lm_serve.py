"""The port's generic greedy server (``launch/serve.py::serve``) on the CPU:
it returns the JAX package's ``stats`` keys and its tokens equal a
hand-rolled greedy loop over ``make_serve_step`` on the same weights
(``init_lm(seed)``); that loop on the JAX package's weights gives the JAX
``serve``'s stream, teacher-forced, a token differing only where the port's
top-2 logit margin is within ``TIE_MARGIN`` 1e-4 (f32 sums of another order
than XLA's); and the CLI with no mode flag serves."""

import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as TT

torch.set_num_threads(1)   # the suite runs six xdist workers on a few cores

ARCH, N, PROMPT, NEW, SLOTS = "llama3.2-1b_smoke", 5, 12, 6, 2
TIE_MARGIN = 1e-4


def _prompts(cfg, seed=0):
    dcfg = DataConfig(seed=seed, vocab_size=cfg.vocab_size, seq_len=PROMPT, global_batch=N)
    return torch.from_numpy(make_batch(dcfg, 0)["tokens"])


def _greedy_loop(params, cfg, prompts, want=None):
    """Feed each prompt token by token, then ``NEW`` greedy tokens; with
    ``want`` (N, NEW) teacher-forced on it, returning the logits margins of
    the positions where the argmax differs."""
    step = tlm.make_serve_step(cfg)
    out, margins = [], []
    for start in range(0, prompts.shape[0], SLOTS):
        batch = prompts[start:start + SLOTS]
        b = batch.shape[0]
        cache = TT.cache_init(cfg, b, PROMPT + NEW, device="cpu")
        for t in range(PROMPT):
            logits, cache = step(params, cache, {"token": batch[:, t:t + 1]}, t)
        toks = []
        for i in range(NEW):
            last = logits[:, -1]
            tok = torch.argmax(last, dim=-1)
            if want is not None:
                forced = torch.from_numpy(want[start:start + b, i]).long()
                for r in torch.nonzero(tok != forced).flatten().tolist():
                    top2 = torch.topk(last[r], 2).values
                    margins.append(float(top2[0] - top2[1]))
                tok = forced
            toks.append(tok)
            if i < NEW - 1:
                logits, cache = step(params, cache, {"token": tok[:, None]}, PROMPT + i)
        out.append(torch.stack(toks, dim=1))
    return torch.cat(out).numpy(), margins


def test_serve_stats_and_tokens_equal_a_greedy_loop():
    done, stats = tserve.serve(ARCH, num_requests=N, prompt_len=PROMPT, max_new=NEW, slots=SLOTS,
                               device="cpu", verbose=False, return_stats=True)
    assert set(stats) == {"prefill_s", "decode_s", "prompt_tokens", "new_tokens",
                          "prefill_tokens_per_s", "decode_tokens_per_s"}
    assert stats["prompt_tokens"] == N * PROMPT and stats["new_tokens"] == N * NEW
    assert [i for i, _ in done] == list(range(N))
    cfg = tlm.get_config(ARCH)
    want, _ = _greedy_loop(TT.init_lm(0, cfg, device="cpu"), cfg, _prompts(cfg))
    np.testing.assert_array_equal(np.stack([t for _, t in done]), want)


def test_greedy_loop_on_jax_weights_gives_jax_stream():
    pytest.importorskip("jax")
    import jax

    from repro.launch import serve as jserve
    from repro.models import lm as jlm
    from repro.models import transformer as JT

    jdone, jstats = jserve.serve(ARCH, num_requests=N, prompt_len=PROMPT, max_new=NEW,
                                 slots=SLOTS, verbose=False, return_stats=True)
    cfg = tlm.get_config(ARCH)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jlm.get_config(ARCH))
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams), "cpu", None)
    want = np.stack([np.asarray(t) for _, t in jdone])
    got, margins = _greedy_loop(params, cfg, _prompts(cfg), want=want)
    assert all(m <= TIE_MARGIN for m in margins), margins
    assert (got != want).sum() == len(margins)
    _, stats = tserve.serve(ARCH, num_requests=N, prompt_len=PROMPT, max_new=NEW, slots=SLOTS,
                            device="cpu", verbose=False, return_stats=True)
    assert set(stats) == set(jstats)


def test_cli_with_no_mode_flag_serves(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", "--requests", "3",
                                      "--prompt-len", "4", "--max-new", "3", "--slots", "2"])
    tserve.main()
    out = capsys.readouterr().out
    assert "[serve] slot batch 1: generated 1x3 tokens" in out
    assert "[serve] 3 requests on cpu: prefill 12 prompt tokens" in out
