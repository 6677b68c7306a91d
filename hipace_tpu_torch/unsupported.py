"""The port queue's items that a deck could select and the port does not
have yet: title -> item number in ROADMAP.md's port queue.

Every path the JAX package runs on one device is ported, so no deck key is
refused. Pipeline parallelism, the queue's next item, runs only on several
devices, which a one-card run never selects. The TPU tuning keys of the JAX
package (hipace.use_banded, banded_*, pallas_*, beam_pallas_*, beam_chunk,
beam_buckets) select no physics and are accepted as no-ops.
"""

ITEMS: dict = {}
