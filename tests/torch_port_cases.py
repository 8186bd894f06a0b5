"""The JAX package's test cases, run against the port.

``port_variant("test_sched.py")`` loads one of the JAX package's test
files with every import of ``k8s_tpu`` (or of the modules named in
``only``) rewritten to ``k8s_tpu_torch``, so its test classes and
fixtures exercise the port's modules with the JAX package's own inputs
and expected verdicts. A port test file takes the classes it wants from
the returned module; pytest collects them there (and the original file
keeps testing the JAX package).
"""

import pathlib
import re
import sys
import types

_TESTS = pathlib.Path(__file__).resolve().parent


def port_variant(filename, only=None, replace=None):
    """The JAX test file ``filename`` as a module whose imports of
    ``k8s_tpu`` (every one, or only the dotted module prefixes in
    ``only``, e.g. ``("k8s_tpu.sched",)``) name the port instead.
    ``replace`` maps literal source strings to their port counterparts
    (e.g. a TPU accelerator name to the GPU one that stands for it)."""
    path = _TESTS / filename
    src = path.read_text()
    for old, new in (replace or {}).items():
        src = src.replace(old, new)
    prefixes = only or ("k8s_tpu",)
    for prefix in prefixes:
        port = "k8s_tpu_torch" + prefix[len("k8s_tpu"):]
        # "from k8s_tpu.x import", "import k8s_tpu.x", "from k8s_tpu import"
        src = re.sub(rf"\b{re.escape(prefix)}(?=[.\s])", port, src)
    name = f"_port_{path.stem}"
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod
