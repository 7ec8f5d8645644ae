"""The DSM math core: convex energies and batched Newton solvers on torch
tensors (:mod:`~superdsm_tpu_torch.dsm.solver`), the padded bucketed
batching of per-region problems (:mod:`~superdsm_tpu_torch.dsm.batching`),
and the Newton gram kernel with its plain version
(:mod:`~superdsm_tpu_torch.dsm.gram`)."""
