"""The reference's checksum cases through the port, part b of three
(LIGHT[1::3]); the method, the split and the time budget are in
tests/torch_checksum_cases.py. Every case skips where the reference's
checkout is absent.
"""

import pytest

from torch_checksum_cases import ARGS, Budget, part, run_case

CASES_HERE = part(1)
# the seconds this file's runs may take, by the cases' reckoned times
BUDGET = Budget(300.0)


@pytest.mark.parametrize(ARGS, CASES_HERE, ids=[c[0] for c in CASES_HERE])
def test_reference_checksum_through_the_port(name, deck, overrides, rtol,
                                             skip_fields, skip_particles,
                                             tmp_path):
    run_case(name, deck, overrides, rtol, skip_fields, skip_particles,
             tmp_path, BUDGET)
