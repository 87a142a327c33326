"""What the benchmark runs loads neither JAX nor the JAX package: top-level
module names are compared whole, so ``tpurpn_torch`` is not ``tpurpn``."""

import subprocess
import sys

from portbench import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
import runpy
import portbench.run, portbench.readings, portbench.check
import portbench.drivers.serve, portbench.drivers.train
import portbench.reference.nets, portbench.reference.serve, portbench.reference.train
import tpurpn_torch, tpurpn_torch.cli
from portbench import harness
print(",".join(harness.forbidden_modules()))
print(",".join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_no_forbidden_module_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(harness.REPO))],
                         capture_output=True, text=True, check=True, timeout=300)
    bad, loaded = out.stdout.split("\n")[:2]
    assert bad == ""
    assert "tpurpn_torch" in loaded.split(",")


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["tpurpn_torch", "tpurpn_torch.kernels", "jaxtyping",
                                      "benchmarks_x"]) == []
    assert harness.forbidden_modules(["tpurpn.model", "jax._src.core", "chip_smoke"]) == [
        "chip_smoke", "jax", "tpurpn"]


def test_reference_imports_nothing_of_the_program():
    probe = ("import sys; sys.path.insert(0, %r); import portbench.reference.serve, "
             "portbench.reference.train, portbench.check; "
             "print(sorted({m.split('.')[0] for m in sys.modules} & "
             "{'tpurpn_torch', 'tpurpn', 'jax'}))" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == "[]"
