"""Shared fixtures of the port's model and engine parity tests: the same
reduced, UNTIED-embedding configs and weights in both packages, and the
engine/reference drivers.  Model logits and pools in float32 agree to atol
1e-4; tokens agree exactly.

``reference`` is ``repro.serve.reference_decode``'s greedy loop over its
oracle ``forward_ref`` (a dense re-forward per token, no cache), jitted
over the context padded to max_seq: the forward is causal, so the padding
never reaches the position read, and one compile per max_seq replaces the
eager reference's compile per context length.  ``test_torch_engine.py``
holds it to ``reference_decode`` itself.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jmodels
from repro.serve.reference import forward_ref
from repro_torch import configs as tcfg
from repro_torch.convert import from_jax
from repro_torch.serve import Request, ServeEngine

# Small tensors: one intra-op thread each, so these tests do not crowd the
# other workers of a parallel run.
torch.set_num_threads(1)
ATOL = 1e-4


def cfgs(arch):
    return tuple(dataclasses.replace(m.get_arch(arch).reduced(),
                                     tie_embeddings=False)
                 for m in (jcfg, tcfg))


class _Models(dict):
    """arch -> (jax cfg, torch cfg, jax params, torch params), each built
    on first use."""

    def __missing__(self, arch):
        cj, ct = cfgs(arch)
        pj = jmodels.init_params(cj, jax.random.PRNGKey(0))
        pt = from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
        self[arch] = (cj, ct, pj, pt)
        return self[arch]


@pytest.fixture(scope="module")
def models():
    return _Models()


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def pools_jax(pools):
    return {k: jnp.asarray(v.numpy()) for k, v in pools.items()}


def serve(pt, ct, kw, prompts, max_new, eos=-1):
    eng = ServeEngine(pt, ct, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new,
                           eos_id=eos))
    done = eng.run_until_drained()
    eng.check_page_invariants()
    return eng, sorted(done, key=lambda r: r.uid)


@functools.partial(jax.jit, static_argnums=1)
def _forward_ref(params, cfg, tokens):
    with jax.ensure_compile_time_eval():   # its per-layer windows are ints
        return forward_ref(params, cfg, tokens)


def reference(pj, cj, req, max_seq):
    """``reference_decode``'s retirement rule: stop after max_new_tokens,
    on eos, or when the context reaches max_seq."""
    ctx, out = list(req.prompt), []
    while len(out) < req.max_new_tokens and len(ctx) < max_seq:
        padded = jnp.asarray([ctx + [0] * (max_seq - len(ctx))], jnp.int32)
        tok = int(jnp.argmax(_forward_ref(pj, cj, padded)[0, len(ctx) - 1]))
        out.append(tok)
        ctx.append(tok)
        if tok == req.eos_id:
            break
    return out
