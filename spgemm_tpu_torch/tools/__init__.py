"""Measurement and verification tools of the port, each run with
`python -m spgemm_tpu_torch.tools.<name>` (counterparts of the JAX
package's `tools/*.py`)."""
