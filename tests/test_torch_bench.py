"""The benchmark's own checks (``torch_bench/tests``) in tier 1, on the CPU:
its arithmetic, the trace and span readers, the correctness comparison of
each cell at a small size, stacks of pairs, the fluid cell and the two 4DCT
cells. Each of their tests is collected here under its own name."""

import pytest

import _torch_helpers  # noqa: F401 (one intra-op thread a worker)

pytest.register_assert_rewrite("torch_bench.tests")

from torch_bench.tests.conftest import small_cell  # noqa: E402,F401 (a fixture)
from torch_bench.tests.test_arithmetic import *  # noqa: E402,F401,F403
from torch_bench.tests.test_correct import *  # noqa: E402,F401,F403
from torch_bench.tests.test_dirlab_cell import *  # noqa: E402,F401,F403
from torch_bench.tests.test_dirlab_thirion_cell import *  # noqa: E402,F401,F403
from torch_bench.tests.test_discard_reader import *  # noqa: E402,F401,F403
from torch_bench.tests.test_fluid_cell import *  # noqa: E402,F401,F403
from torch_bench.tests.test_fluid_readers import *  # noqa: E402,F401,F403
from torch_bench.tests.test_span_readers import *  # noqa: E402,F401,F403
from torch_bench.tests.test_stack import *  # noqa: E402,F401,F403
from torch_bench.tests.test_trace_readers import *  # noqa: E402,F401,F403
