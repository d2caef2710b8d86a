"""The port's own Q_TO_LL table and threshold helper against the JAX
package's, bit for bit."""
import numpy as np
import pytest

from kmer_hasher_tpu import qll as jqll
from kmer_hasher_tpu_torch import qll as tqll


def test_table_is_bitwise_the_jax_packages():
    assert tqll.Q_TO_LL.dtype == np.float64 and tqll.Q_TO_LL.shape == (256,)
    np.testing.assert_array_equal(tqll.Q_TO_LL.view(np.uint64),
                                  jqll.Q_TO_LL.view(np.uint64))


@pytest.mark.parametrize("min_q", [0, 2, 20, 40, 93, 222])
def test_min_ll_for_phred_matches(min_q):
    assert tqll.min_ll_for_phred(min_q) == jqll.min_ll_for_phred(min_q)


@pytest.mark.parametrize("min_q", [-34, 223])
def test_min_ll_for_phred_rejects_out_of_range(min_q):
    with pytest.raises(ValueError):
        tqll.min_ll_for_phred(min_q)
