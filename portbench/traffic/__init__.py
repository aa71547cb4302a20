"""Traffic generators (one a file) and traffic mixes (``<mix>.json``, the
parameters one generator reads)."""
