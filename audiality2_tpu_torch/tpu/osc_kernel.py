"""The device pair atlas of the copied ``engine/core.py``
(``pair_atlas_entry``): the port's ``cuda.osc_kernel.PairAtlas``."""

from ..cuda.osc_kernel import PairAtlas

__all__ = ["PairAtlas"]
