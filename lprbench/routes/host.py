"""``InferenceServer.submit`` with the run's frame as a host ``uint8``
array: the collector gathers, copies and uploads it."""


class Route:
    def __init__(self, server, frames):
        self.server, self.frames = server, frames

    def submit(self, i: int):
        return self.server.submit(self.frames[i])
