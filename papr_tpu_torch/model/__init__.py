"""Model: point cloud, proximity attention and UNet decode (counterpart of ``papr_tpu/model``)."""
