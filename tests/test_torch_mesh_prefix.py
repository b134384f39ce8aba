"""An engine on a mesh narrower than its world (the port's fault P3).

A ``(1, 2)`` engine runs on the first two ranks of a gloo world of 4 on
the CPU; ranks 2 and 3 build the mesh and serve nothing. ``drain``
checks the ranks' tokens with ``distributed.all_equal``, which must
gather over the mesh's ranks only: gathered over the world, ranks 0 and
1 wait for ranks that never enter the collective, and the world does
not finish. The test's own time limit (``LIMIT_S``) is well under the
process group's timeout (``distributed.TIMEOUT_S``), so that wait fails
it rather than holding the suite.
"""
from __future__ import annotations

import torch_tp_ranks as ranks
from repro_torch import distributed
from repro_torch.launch import mesh as mesh_lib

LIMIT_S = 120


def test_engine_on_a_mesh_narrower_than_its_world_drains():
    assert LIMIT_S < distributed.TIMEOUT_S / 2
    single = ranks.prefix_drain()
    got = mesh_lib.spawn(ranks.prefix_engine_world, 4, "gloo", "cpu",
                         timeout=LIMIT_S)
    assert got[2] is None and got[3] is None
    assert got[0] == got[1] == single
    assert all(len(t) == new for t, (_, _, new) in
               zip(single, ranks.PREFIX_PROMPTS))
