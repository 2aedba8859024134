"""Multi-device pieces of the port: the sharding rules and activation pins
(``sharding``), the counted collectives (``comm``), tensor-parallel
compute along ``model`` (``tensor_parallel``), the sharded training
state (``zero``), a forward split over the data ranks (``data_parallel``),
expert-parallel MoE (``ep_moe``), the int8 error-feedback all-reduce
(``compression``) and the GPipe/C-slow pipeline schedule (``pipeline``)."""
