"""Command-line tools of the port: the job launcher (``launch``)."""
