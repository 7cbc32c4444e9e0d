"""The port's ring attention against the JAX package's, on the CPU.

Inputs [B 3, H 2, S 16, Dh 8] in float32 with a key padding mask: batch
element 0 pads a tail, element 1 pads its last 8 keys (a whole shard at sp =
2, two at sp = 4), element 2 is all padding. ``mer_tpu``'s
``ring_attention`` runs on 2 and 4 of its virtual devices, with its jnp
block body and with its kernel body (the Pallas forward in interpret mode);
the port's ring runs over gloo (four ranks, one spawn for the module:
``tests/_torch_parallel_worker.py``; sp = 2 as two rings of two ranks, and
sp = 4) and as a local ring on one device, with its plain block (what CPU
tensors run) and with its kernel block (``FlashAttention``: the plain
versions of K1 and K4 on the CPU, the kernels' algebra). Forward within
1e-5, gradients within 2e-5. The kernel block's merge gives a fully masked
block the weight 0 exactly, so the padded shard's keys get no gradient; on
the all-padding element the kernel rings' dq and dk are the backward
kernel's convention (the plain attention's differentiate a constant) and
are not compared, while out and dv are the plain attention's. ``mer_tpu``'s
kernel ring merges an all-padding element's blocks with weight 1 each (a sum
of block means), so it is held on elements 0 and 1 alone.
"""

import concurrent.futures
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mer_tpu_torch.ops import flash_attention as fa
from mer_tpu_torch.ops import ring_attention as ring

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO_ROOT, "tests", "_torch_parallel_worker.py")
B, H, S, DH = 3, 2, 16, 8
FWD, GRAD = 1e-5, 2e-5
NAMES = ("out", "dq", "dk", "dv")


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the cores; two torch threads per test, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.normal(size=(B, H, S, DH)).astype(np.float32) for _ in range(4))
    mask = np.zeros((B, S), bool)
    mask[0, 11:] = True
    mask[1, S // 2:] = True
    mask[2] = True
    return {"q": q, "k": k, "v": v, "g": g, "mask": mask}


@pytest.fixture(scope="module")
def jax_side():
    """(jax, jax.numpy, mer_tpu's ring_attention module, its make_mesh), imported here so that the card's leg
    collects where JAX is not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from mer_tpu.ops import ring_attention as jax_ring
    from mer_tpu.parallel import make_mesh as jax_make_mesh

    return jax, jnp, jax_ring, jax_make_mesh


def _jax_ring(jax_side, x, sp, kernel):
    jax, jnp, jax_ring, jax_make_mesh = jax_side
    mesh = jax_make_mesh(dp=1, tp=1, sp=sp, devices=jax.devices()[:sp])
    fn = lambda q, k, v: jax_ring.ring_attention(q, k, v, mesh=mesh, key_padding_mask=jnp.asarray(x["mask"]),
                                                 use_kernel=kernel, interpret=kernel)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x[n]) for n in "qkv"))
    return dict(zip(NAMES, (np.asarray(t) for t in (out, *vjp(jnp.asarray(x["g"]))))))


def _port_ring(x, fn):
    q, k, v = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    out = fn(q, k, v, torch.from_numpy(x["mask"]))
    out.backward(torch.from_numpy(x["g"]))
    return dict(zip(NAMES, (t.detach().numpy() for t in (out, q.grad, k.grad, v.grad))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_side):
    """The gloo rings (spawned once) and ``mer_tpu``'s rings meanwhile."""
    workdir = str(tmp_path_factory.mktemp("ring"))
    x = _inputs()
    np.savez(os.path.join(workdir, "ring_inputs.npz"), **x)
    port, env = _free_port(), {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, WORKER, "ring", str(r), "4", str(port), workdir], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    cases = [(sp, kernel) for sp in (2, 4) for kernel in (False, True)]
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:  # XLA compiles outside the GIL
        want = dict(zip(cases, pool.map(lambda case: _jax_ring(jax_side, x, *case), cases)))
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    gloo = {sp: dict(np.load(os.path.join(workdir, f"ring_sp{sp}.npz"))) for sp in (2, 4)}
    return {"x": x, "want": want, "gloo": gloo}


def _assert_close(got, want, elements=slice(None), names=NAMES, what=""):
    for name in names:
        np.testing.assert_allclose(got[name][elements], want[name][elements], rtol=0,
                                   atol=FWD if name == "out" else GRAD, err_msg=f"{what} {name}")


def _kernel_block_ring(q, k, v, mask, sp):
    """The local ring with the kernel block (FlashAttention) on CPU tensors."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ring, "_body", lambda q: ring._KernelBody)
        return ring.ring_attention(q, k, v, key_padding_mask=mask, sp=sp)


@pytest.mark.parametrize("sp", [2, 4])
def test_plain_rings_equal_mer_tpu_jnp_ring(runs, sp):
    """The plain block, over gloo and as a local ring, against ``mer_tpu``'s
    jnp ring: every element, every output."""
    want = runs["want"][(sp, False)]
    _assert_close(runs["gloo"][sp], want, what=f"gloo sp={sp}")
    local = _port_ring(runs["x"], lambda q, k, v, m: ring.ring_attention(q, k, v, key_padding_mask=m, sp=sp))
    _assert_close(local, want, what=f"local sp={sp}")


@pytest.mark.parametrize("sp", [2, 4])
def test_kernel_block_ring_equals_mer_tpu_kernel_ring(runs, sp):
    got = _port_ring(runs["x"], lambda q, k, v, m: _kernel_block_ring(q, k, v, m, sp))
    _assert_close(got, runs["want"][(sp, True)], elements=slice(0, 2), what=f"sp={sp}")


@pytest.mark.parametrize("sp", [2, 4])
def test_kernel_block_ring_is_the_plain_attention_under_padding(runs, sp):
    """The shard that padding fills weighs exactly 0: its keys get no
    gradient; the all-padding element's out and dv are the plain attention's."""
    x = runs["x"]
    got = _port_ring(x, lambda q, k, v, m: _kernel_block_ring(q, k, v, m, sp))

    def plain(q, k, v, m):
        return fa.flash_attention_reference(q, k, v, m)[0]

    want = _port_ring(x, plain)
    _assert_close(got, want, elements=slice(0, 2), what=f"sp={sp}")
    _assert_close(got, want, elements=2, names=("out", "dv"), what=f"all padding sp={sp}")
    assert not got["dk"][1, :, S // 2:].any() and not got["dv"][1, :, S // 2:].any()


def test_indivisible_sequence_raises(jax_side):
    jax, jnp, jax_ring, jax_make_mesh = jax_side
    q = torch.zeros(1, 1, 15, 8)
    with pytest.raises(ValueError, match="must divide sp=2"):
        ring.ring_attention(q, q, q, sp=2)
    with pytest.raises(ValueError, match="must divide sp=2"):
        jax_ring.ring_attention(jnp.zeros((1, 1, 15, 8)), jnp.zeros((1, 1, 15, 8)), jnp.zeros((1, 1, 15, 8)),
                                mesh=jax_make_mesh(dp=1, tp=1, sp=2, devices=jax.devices()[:2]))


def test_without_an_sp_axis_it_is_the_attention():
    x = _inputs()
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    mask = torch.from_numpy(x["mask"])
    torch.testing.assert_close(ring.sequence_parallel_attention(q, k, v, key_padding_mask=mask),
                               fa.flash_attention_reference(q, k, v, mask)[0])


@pytest.mark.cuda
def test_local_ring_on_the_card_launches_k1_and_k4_per_block():
    """On the card each block is K1 forward and K4 backward: sp launches a
    ring step, sp x sp a call, held to the plain full attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = _inputs()
    sp = 2
    q, k, v = (torch.from_numpy(x[n]).cuda().requires_grad_() for n in "qkv")
    mask = torch.from_numpy(x["mask"]).cuda()
    mask[2, 0] = False  # no all-padding element: K4's convention there is not the plain attention's
    fa.flash_attention_forward.launches = fa.flash_attention_tiled_backward.launches = 0
    fa.flash_attention_backward.launches = 0
    torch.backends.cuda.matmul.allow_tf32 = False
    out = ring.ring_attention(q, k, v, key_padding_mask=mask, sp=sp)
    out.backward(torch.from_numpy(x["g"]).cuda())
    assert fa.flash_attention_forward.launches == sp * sp
    assert fa.flash_attention_backward.launches + fa.flash_attention_tiled_backward.launches == sp * sp
    got = [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]
    qc, kc, vc = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    ref = fa.flash_attention_reference(qc, kc, vc, mask.cpu())[0]
    ref.backward(torch.from_numpy(x["g"]))
    for a, b in zip(got, (ref.detach(), qc.grad, kc.grad, vc.grad)):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD)
