"""Optimizer and gradient compression of the port's LM training (the JAX
package's `optim/`)."""
