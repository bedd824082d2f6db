"""Training of the window classifier (the variant side of the JAX
package's train/): the step, the loop, the resume state and hyperband."""
