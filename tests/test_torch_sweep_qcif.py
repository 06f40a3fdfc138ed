"""torch port: the qcif cases of the encoder's flag sweep on the CPU
(ABR at -kbps=600, SCD on and off over the fixture's scene cut,
-varint=0 -ipct=50): each stream of the port's CLI, and the port's
decode of it, equals `dsv2_tpu`'s golden digest. The tiny cases are in
tests/test_torch_sweep.py."""
import pytest

from test_torch_sweep import sweep_case
import torch_port_golden as golden  # after torch_parity (sys.path)

CASES = [c for c in golden.sweep_cases() if "qcif" in c[1]]


@pytest.mark.parametrize("k,name,args", CASES, ids=[c[0] for c in CASES])
def test_sweep_qcif(k, name, args, tmp_path):
    sweep_case(k, name, args, tmp_path)
