import threading


class Prefetcher:
    def start(self):
        self._worker = threading.Thread(target=self.run)
        self._worker.start()
        self._probe = threading.Thread(target=self.run, daemon=True)
        self._probe.start()

    def run(self):
        pass

    def close(self):
        self._worker.join()
