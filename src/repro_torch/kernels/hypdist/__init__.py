"""RHG feature rows for the ``hyp`` tile of the pair-mask kernel."""
