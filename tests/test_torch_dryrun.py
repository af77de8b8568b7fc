"""``python -m pypic_tpu_torch.tools.dryrun`` (the counterpart of
``__graft_entry__.dryrun_multichip``) at 2 gloo ranks on the CPU: JAX's
modes in JAX's order, every ported mode ok with JAX's invariants, and
exactly the three modes that need ROADMAP item 18 reported not ported
(not passed); the exit code 0.
"""

import __graft_entry__ as graft

from pypic_tpu_torch.tools import dryrun

ITEM18 = {"2b-explicit-superstep", "3b-implicit-superstep",
          "10-dp-carried-deposit"}


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
    assert {n for n, s in status.items() if s == dryrun.NOT_PORTED} == ITEM18
    assert all(s == "ok" for n, s in status.items() if n not in ITEM18), status
    assert lines[-1].startswith("dryrun: 13 of 13 ported modes ok, 3 not "
                                "ported, 0 failed (2 ranks, gloo on cpu)")
