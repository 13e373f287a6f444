import threading


class Prefetcher:
    def start(self):
        self._worker = threading.Thread(target=self.run)   # R012
        self._worker.start()

    def run(self):
        pass
