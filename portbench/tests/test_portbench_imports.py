"""A run holds no module whose top-level name is ``jax`` or the JAX
package's (a whole-name compare: the port's name starts with the JAX
package's), and the reference imports nothing of the program."""

import os
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "parallel_gcn_tpu"}

RUN = """
import sys, tempfile
sys.path.insert(0, {repo!r})
import pytest
from portbench.tests import conftest
from portbench import harness
class MP:
    def setattr(self, obj, name, value): setattr(obj, name, value)
import pathlib
tmp = pathlib.Path(tempfile.mkdtemp(dir={tmp!r}))
add = next(conftest.tiny_root.__wrapped__(tmp, MP()))
harness.run("gcn-reddit.seeds4", 11, 0.2, True, t_start=0.0, require_cuda=False,
            log=lambda m: None)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import sys
sys.path.insert(0, {repo!r})
import portbench.reference.common, portbench.reference.gcn, portbench.reference.sage
import portbench.reference.philox, portbench.data
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(p.stdout.split("\n")[-2].split())


def test_a_run_holds_no_jax(tmp_path):
    mods = _modules(RUN.format(repo=harness.REPO_DIR, tmp=str(tmp_path)))
    assert "parallel_gcn_tpu_torch" in mods and "portbench" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules(REF.format(repo=harness.REPO_DIR))
    assert not mods & (FORBIDDEN | {"parallel_gcn_tpu_torch"}), mods
