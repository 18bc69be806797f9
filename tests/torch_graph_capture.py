"""A stand-in for CUDA graph capture in the port's CPU tests."""


class EagerCapture:
    """`utils/graphs.GraphCache`'s capture on the CPU: "replay" runs the
    step again and writes what it returns (a tensor or a tuple of them) into
    the tensors the capture handed out, as a CUDA graph's replay would."""

    def __init__(self):
        self.captures = 0

    def __call__(self, run, device):
        self.captures += 1
        first = run()
        if isinstance(first, tuple):
            out = tuple(t.clone() for t in first)

            def replay():
                for o, t in zip(out, run()):
                    o.copy_(t)
        else:
            out = first.clone()

            def replay():
                out.copy_(run())
        return replay, out
