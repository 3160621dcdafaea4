"""Host utilities of the port: the native g++ helpers, the server's offline
artifact (``checkpoint``) and the tracing and profiling spans
(``profiling``)."""
