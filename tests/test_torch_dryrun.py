"""``python -m pypic_tpu_torch.tools.dryrun`` (the counterpart of
``__graft_entry__.dryrun_multichip``) at 2 gloo ranks on the CPU: JAX's
modes in JAX's order, every mode ok with JAX's invariants (the
supersteps and the carried magnetized deposit under data parallelism
among them); the exit code 0.
"""

import __graft_entry__ as graft

from pypic_tpu_torch.tools import dryrun

def test_dryrun_two_ranks(capsys):
    assert [name for name, _ in dryrun.MODES] == [name for name, _ in
                                                  graft._MODES]
    assert dryrun.main(["--ranks", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    status = {}
    for line in lines[:-1]:
        head, note = line.split(": ", 1)
        status[head[len("dryrun["):-1]] = note
    assert list(status) == [name for name, _ in dryrun.MODES]
    assert all(s == "ok" for s in status.values()), status
    assert lines[-1].startswith("dryrun: 16 of 16 modes ok, 0 failed "
                                "(2 ranks, gloo on cpu)")
