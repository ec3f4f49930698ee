"""Tensor ops of the flow: masks, squeeze/factor, coupling law, logit."""
