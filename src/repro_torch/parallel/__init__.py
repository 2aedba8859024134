"""Multi-device pieces of the port: the sharding rules (``sharding``), the
counted collectives (``comm``), a forward split over the data ranks
(``data_parallel``) and expert-parallel MoE (``ep_moe``).  The
pipeline schedule and gradient compression of the reference's package are
not ported yet (ROADMAP.md, Queue 1 item 12b)."""
