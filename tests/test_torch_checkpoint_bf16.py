"""bfloat16 leaves in the port's checkpoints, on the CPU.

numpy has no bfloat16: the reference writes such a leaf as its raw 2-byte
data (``|V2``) with ``"dtype": "bfloat16"`` in the manifest, and the port
writes it the same way and restores it from its bits by that dtype.  Both
checks are exact, bit for bit.  (The reference's own ``restore`` cannot
read such a leaf back, ``ValueError: No cast function available``: a
reference hazard, ROADMAP Queue 3.)
"""
import numpy as np
import pytest
from jax_programs import release_jax_programs  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_port_bf16_checkpoint_round_trips(tmp_path):
    gen = torch.Generator().manual_seed(0)
    t = {"params": {"embed": torch.randn(5, 3, generator=gen).bfloat16(),
                    "ln": torch.randn(3, generator=gen),
                    "h": torch.randn(2, 2, generator=gen).half()},
         "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    t["params"]["embed"][0, 0] = float("-inf")
    ckpt.save(str(tmp_path), 3, t)
    manifest = ckpt.read_manifest(str(tmp_path), 3)["arrays"]
    assert manifest["['params']/['embed']"]["dtype"] == "bfloat16"
    assert manifest["['params']/['h']"]["dtype"] == "float16"
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as data:
        assert data["['params']/['embed']"].dtype == np.dtype("V2")
    zeros = {"params": {k: torch.zeros_like(v)
                        for k, v in t["params"].items()},
             "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    back = ckpt.restore(str(tmp_path), 3, zeros)
    for k in t["params"]:
        assert back["params"][k].dtype == t["params"][k].dtype
        assert torch.equal(_bits(back["params"][k]), _bits(t["params"][k]))
    assert int(back["opt"]["step"]) == 7


def test_reference_bf16_checkpoint_restores_in_port(tmp_path):
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.standard_normal((4, 6)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    jckpt.save(str(tmp_path), 2, {"params": {"w": w, "b": jnp.ones(6)}})
    assert jckpt.read_manifest(str(tmp_path), 2)["arrays"][
        "['params']/['w']"]["dtype"] == "bfloat16"
    back = ckpt.restore(str(tmp_path), 2, {"params": {
        "w": torch.zeros(4, 6, dtype=torch.bfloat16), "b": torch.zeros(6)}})
    assert back["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["params"]["w"].view(torch.int16)
                                  .numpy(), np.asarray(w).view(np.int16))
    assert torch.equal(back["params"]["b"], torch.ones(6))
