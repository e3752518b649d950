"""repro_torch.launch: the roofline model on the H100's peaks
(:mod:`.roofline`) and the analytic bytes and operations of the port's
kernel launches (:mod:`.cost`), from which ``chip_smoke.py`` states
every bound of its kernels line; and the training driver
(:mod:`.train`, ``python -m repro_torch.launch.train``)."""
