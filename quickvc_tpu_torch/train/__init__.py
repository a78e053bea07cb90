"""GAN training of the port: state, one step, the loop and its CLI."""
