"""The second launch of every norm backward: dw's partial rows summed in
a fixed order.  Its least time lies inside each backward's bound
(families ``norm_bwd`` and ``qk_norm_rope_bwd``); its device time counts
here."""
PATTERN = r"sum_partials_kernel"
ENTRIES = {"rmsnorm_bwd": "repro_torch.kernels.rmsnorm.kernel",
           "add_rmsnorm_bwd": "repro_torch.kernels.rmsnorm.kernel",
           "qk_norm_rope_bwd": "repro_torch.kernels.rmsnorm.kernel"}
