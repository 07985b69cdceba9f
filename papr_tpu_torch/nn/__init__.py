"""Neural-network building blocks (counterparts of ``papr_tpu/nn``)."""
