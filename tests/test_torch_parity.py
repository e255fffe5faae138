"""Shared set-up of the tests that run one pipeline through both packages
(``pathway_tpu`` and ``pathway_tpu_torch``) in one process."""

import pathway_tpu.internals.keys as jkeys
import pathway_tpu_torch.internals.keys as tkeys


def align_row_ids() -> None:
    """Start both packages' row-id sequences at the same number. Rows
    without a primary key take their ids from a process-wide counter in
    each package, and ids break ties between equal scores and order some
    outputs; a test that ran one package alone earlier in the process
    would otherwise leave the two counters, and so those orders, apart."""
    with jkeys._seq_lock, tkeys._seq_lock:
        jkeys._seq_next = tkeys._seq_next = max(jkeys._seq_next, tkeys._seq_next)


def test_aligned_row_id_sequences_give_both_packages_the_same_keys():
    from pathway_tpu.internals.keys import sequential_key as jax_key
    from pathway_tpu_torch.internals.keys import sequential_key as port_key

    jax_key()  # one package ahead of the other, as a one-sided test leaves them
    align_row_ids()
    assert [port_key().value for _ in range(3)] == [jax_key().value for _ in range(3)]
