"""Launch layer of the port: the training and serving entry points
(``python -m repro_torch.launch.train`` / ``... .serve``). The reference's
production mesh, shape specs and roofline arithmetic are not here yet."""
