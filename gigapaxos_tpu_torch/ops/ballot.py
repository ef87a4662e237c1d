"""Ballot packing: (num, coord) as one int32, comparable with plain ``>``.

The reference keeps ballots as two ints (``PaxosAcceptor.java:82-88``:
``ballotNum``, ``ballotCoord``) and compares lexicographically.  For the
vectorized engine a ballot is a single int32 ``num << COORD_BITS | coord``
so that ballot comparison, max-reduction, and promise updates are single
element-wise ops over ``[G]`` arrays.  ``COORD_BITS=5`` supports up to 32
replica ids (> reference ``MAX_GROUP_SIZE`` 16, ``PaxosConfig.java:532``)
and ballot numbers up to 2^26.  -1 is the null ballot (less than any valid
ballot since valid encodings are >= 0).
"""

from __future__ import annotations

COORD_BITS = 5
COORD_MASK = (1 << COORD_BITS) - 1
NULL = -1


def encode_ballot(num, coord):
    """Works on python ints and jnp arrays alike."""
    return (num << COORD_BITS) | coord


def ballot_num(bal):
    return bal >> COORD_BITS


def ballot_coord(bal):
    return bal & COORD_MASK
