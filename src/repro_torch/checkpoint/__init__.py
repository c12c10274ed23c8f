"""Checkpoints (`ckpt`): one `.npy` a leaf and a `meta.json`, the JAX
package's layout."""
