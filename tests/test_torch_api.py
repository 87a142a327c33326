"""The port's public surface against ``tpurpn``'s, and its independence.

Every name of ``tpurpn.__all__`` is in ``tpurpn_torch.__all__`` and resolves
there. Importing the port and each of its modules (in a fresh interpreter)
loads no JAX, flax or ``tpurpn``.
"""

import os
import pkgutil
import subprocess
import sys

import tpurpn
import tpurpn_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every name of tpurpn's is ported
NOT_PORTED = set()


def test_every_tpurpn_name_is_exported_by_the_port():
    missing = set(tpurpn.__all__) - set(tpurpn_torch.__all__)
    assert missing == NOT_PORTED
    for name in tpurpn_torch.__all__:
        assert getattr(tpurpn_torch, name) is not None, name
    for name in ("proposal_recall", "get_step_size", "rpn_generator"):
        assert callable(getattr(tpurpn_torch, name))
    assert isinstance(tpurpn_torch.__version__, str)


def test_the_port_imports_no_jax_flax_or_tpurpn():
    modules = sorted(
        m.name for m in pkgutil.walk_packages(tpurpn_torch.__path__, "tpurpn_torch.")
    )
    # the modules of this slice among them, and the entry scripts
    for name in ("eval", "io_utils", "native", "data", "drawing", "profiling", "cli"):
        assert f"tpurpn_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import tpurpn_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import rpn_predictor_torch, rpn_trainer_torch\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpurpn'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
