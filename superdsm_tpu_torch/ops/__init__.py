"""Low-level image operations: Gaussian filtering on the selected torch
device (:mod:`~superdsm_tpu_torch.ops.gaussian`), and the host-side
distance transforms, watershed and morphology carried over from the JAX
package."""
