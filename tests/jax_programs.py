"""Frees the XLA programs that a port test module compiled.

JAX's caches keep every compiled executable, and an XLA CPU executable
holds its code in memory mappings of its own: one reference ``partition()``
with trials adds about ten thousand.  A pytest process that calls the
reference for module after module reaches the kernel's limit on mappings
(``vm.max_map_count``, 65,530 by default), and its next compile crashes
the process.  Every port test module that calls the reference imports
:func:`release_jax_programs`; the fixture is autouse and module-scoped, so
once a module's tests in a process are done, JAX's caches are cleared
and the mappings go back to the kernel.
"""
import gc
import sys

import pytest


@pytest.fixture(autouse=True, scope="module")
def release_jax_programs():
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
        gc.collect()
