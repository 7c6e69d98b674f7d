"""``repro_torch.launch.dryrun.run_cell`` over the 2-pod production mesh
-- rank 0 of a fake group of 512 ranks (2x16x16; the port's step takes its
(pod, data) axes as one data axis of 32, ``dryrun.step_mesh``) -- for every
smoke family in all three modes, as ``test_torch_dryrun_cells.py`` does at
16x16. ~30 s alone.
"""

import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401  (autouse)
from test_torch_dryrun_cells import FAMILIES, MODES, check_cell


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_family_cell_is_ok_on_two_pods(arch, mode):
    check_cell(True, arch, mode)
