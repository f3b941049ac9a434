"""Text analyzers (tokenizer pipelines).

Reference analog: libs/iresearch/analysis/ — 53 files / 25+ analyzers
(SURVEY.md §2.7). Analysis is pointer-chasing CPU work in any architecture;
it stays on host here too (the reference's design point holds: term matching
on CPU, scoring on the accelerator — SURVEY.md §7 hard part 5).

Implemented: locale text analyzers (unicode word split + per-language
stopwords + snowball-family stemming + CJK bigrams), whitespace, keyword,
ngram, edge_ngram, delimiter, multi_delimiter, segmentation, normalizing,
collation, stem, pattern, path_hierarchy, synonyms, pipeline, union,
minhash. The registry mirrors the reference's named-tokenizer catalog
objects (CREATE ... TOKENIZER options; analysis/pipeline_tokenizer.cpp,
solr_synonyms_tokenizer.cpp, minhash_tokenizer.cpp, ...).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from .. import errors
from .stemmers import lang_of as _lang_of
from .stemmers import porter2, stemmer_for

_WORD_RE = re.compile(r"\w+", re.UNICODE)

# CJK codepoint runs are split into overlapping bigrams (the standard
# segmentation approximation the reference gets from ICU break iterators)
_CJK_RE = re.compile(
    "[\u3400-\u4dbf\u4e00-\u9fff\uf900-\ufaff"
    "\u3040-\u30ff\uac00-\ud7af]")

# per-language stopword lists (reference: snowball lists via libstemmer;
# compact high-frequency subsets keep index/query symmetric)
EN_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split())
DE_STOPWORDS = frozenset(
    "aber als am an auch auf aus bei bin bis das dass dem den der des die "
    "durch ein eine einem einen einer es für hat ich im in ist mit nach "
    "nicht noch nur oder sich sie sind so über um und von vor war wie wird "
    "zu zum zur".split())
FR_STOPWORDS = frozenset(
    "au aux avec ce ces dans de des du elle en et eux il ils je la le les "
    "leur lui ma mais me même mes moi mon ne nos notre nous on ou par pas "
    "pour qu que qui sa se ses son sur ta te tes toi ton tu un une vos "
    "votre vous".split())
ES_STOPWORDS = frozenset(
    "a al algo como con de del desde donde el ella ellas ellos en entre "
    "era es esta este ha hay la las le les lo los me mi muy más ni no nos "
    "o para pero por que se sin sobre su sus te tiene un una uno y ya".split())
RU_STOPWORDS = frozenset(
    "и в во не что он на я с со как а то все она так его но да ты к у же "
    "вы за бы по только ее мне было вот от меня еще нет о из ему".split())
IT_STOPWORDS = frozenset(
    "a ad al alla alle anche che chi ci come con da dal de del della di "
    "e ed è era gli ha hanno il in io la le lo ma mi nel nella non o per "
    "più quella questo se si sono su un una uno".split())
PT_STOPWORDS = frozenset(
    "a ao aos as com da das de dele do dos e ela elas ele eles em entre "
    "essa esse esta este eu foi há isso já mais mas me mesmo na nas não "
    "no nos nós o os ou para pela pelo por qual quando que se sem seu sua "
    "também te um uma você".split())
NL_STOPWORDS = frozenset(
    "aan als bij dan dat de der die dit een en er haar had heeft het hij "
    "hoe ik in is je kan maar me met mijn naar niet nog nu of om onder "
    "ook op over te tot uit van voor was wat we wel wij zal ze zich zij "
    "zijn zo".split())
SV_STOPWORDS = frozenset(
    "alla att av blev bli den det detta dig din du där då efter ej eller "
    "en er ett från för ha hade han hans har hon i icke inte jag kan man "
    "med mig min mot mycket ni nu när och om oss på samma sedan sig sin "
    "som så till under upp vad var vara varför vi vid är".split())
FI_STOPWORDS = frozenset(
    "ei en että he hän ja jo jos kanssa kun me mikä minä mutta myös ne "
    "niin nyt ole oli on ovat se sen siellä sinä tai tämä vain voi".split())
DA_STOPWORDS = frozenset(
    "af alle at blev da de dem den denne der deres det dette dig din dog "
    "du efter eller en end er et for fra ham han hans har havde have hun "
    "hvad hvis hvor i ikke ind jeg jer kan man med meget men mig min "
    "mine mit nogle nu når og også om op os over på selv sig skal skulle "
    "som sådan thi til ud under var vi vil ville vor være været".split())
NO_STOPWORDS = frozenset(
    "alle at av da de deg den denne der dere deres det dette du eller en "
    "er et etter for fra ha hadde han hans har hun hva hvis hvor i ikke "
    "jeg kan man med meg men mer min mitt mot noe noen nå og også om opp "
    "oss over på seg selv sin sitt skal skulle som så til ut var vi vil "
    "ville vår være vært".split())
RO_STOPWORDS = frozenset(
    "acea aceasta această al ale am ar are as au că ce cel cu da dar de "
    "din dintre doar după ei el ele este eu fi fie fost iar în între la "
    "le lor lui mai mult nu o ori pe pentru prin sa să sau se si și sunt "
    "tot un una unei unui va voi vor".split())
TR_STOPWORDS = frozenset(
    "acaba ama ancak bana bazı belki ben beni bir biri birkaç biz bu "
    "çok çünkü da daha de defa diye en gibi hem hep hepsi her hiç için "
    "ile ise kez ki kim mi mu mü nasıl ne neden nerde nerede nereye niye "
    "o sanki şey siz şu tüm ve veya ya yani".split())
HU_STOPWORDS = frozenset(
    "a az abban ahhoz ahogy aki akik akkor amely amelyek ami amit arra "
    "azok azonban be csak de e egy egyéb egyik el ez ezek ezen ezt fel "
    "hogy ha hanem hiszen igen ill illetve is ki le lehet maga más meg "
    "mert mi mint mintha nem nincs olyan ott össze pedig s saját sem "
    "semmi sok szerint szinte talán úgy új vagy van volt".split())

STOPWORDS_BY_LANG = {
    "en": EN_STOPWORDS, "de": DE_STOPWORDS, "fr": FR_STOPWORDS,
    "es": ES_STOPWORDS, "ru": RU_STOPWORDS, "it": IT_STOPWORDS,
    "pt": PT_STOPWORDS, "nl": NL_STOPWORDS, "sv": SV_STOPWORDS,
    "fi": FI_STOPWORDS, "da": DA_STOPWORDS, "no": NO_STOPWORDS,
    "nb": NO_STOPWORDS, "nn": NO_STOPWORDS, "ro": RO_STOPWORDS,
    "tr": TR_STOPWORDS, "hu": HU_STOPWORDS,
}


def _porter_light(token: str) -> str:
    """English stemmer — full Porter2 (stemmers.py). The name survives as
    the historical seam used across the index/query sides."""
    return porter2(token)


def _cjk_split(term: str, pos: int, start: int) -> list["Token"]:
    """Split a \\w+ run containing CJK into script-run tokens: non-CJK runs
    stay whole, CJK runs become overlapping bigrams (unigram when length
    1) — the ICU-segmentation approximation for unspaced scripts."""
    out = []
    i = 0
    n = len(term)
    while i < n:
        if _CJK_RE.match(term[i]):
            j = i
            while j < n and _CJK_RE.match(term[j]):
                j += 1
            run = term[i:j]
            if len(run) == 1:
                out.append(Token(run, pos, start + i, start + i + 1))
                pos += 1
            else:
                for k in range(len(run) - 1):
                    out.append(Token(run[k:k + 2], pos, start + i + k,
                                     start + i + k + 2))
                    pos += 1
            i = j
        else:
            j = i
            while j < n and not _CJK_RE.match(term[j]):
                j += 1
            out.append(Token(term[i:j], pos, start + i, start + j))
            pos += 1
            i = j
    return out


@dataclass
class Token:
    term: str
    position: int
    start: int = 0
    end: int = 0


class Analyzer:
    name = "keyword"

    def tokenize(self, text: str) -> list[Token]:
        raise NotImplementedError

    def terms(self, text: str) -> list[str]:
        return [t.term for t in self.tokenize(text)]


class KeywordAnalyzer(Analyzer):
    name = "keyword"

    def tokenize(self, text: str) -> list[Token]:
        return [Token(text, 0, 0, len(text))] if text else []


class WhitespaceAnalyzer(Analyzer):
    name = "whitespace"

    def tokenize(self, text: str) -> list[Token]:
        out = []
        pos = 0
        for m in re.finditer(r"\S+", text):
            out.append(Token(m.group(), pos, m.start(), m.end()))
            pos += 1
        return out


class TextAnalyzer(Analyzer):
    """Locale text analyzer: NFC normalize, lowercase, word split (CJK
    runs → bigrams), accent fold, per-language stopwords + stemming
    (reference: analysis/text_tokenizer.cpp; locale handling mirrors its
    ICU locale option)."""

    name = "text"

    def __init__(self, stopwords: Optional[frozenset] = None,
                 stem: bool = True, accent_fold: bool = True,
                 locale: str = "en"):
        lang = _lang_of(locale)
        if stopwords is None:
            stopwords = STOPWORDS_BY_LANG.get(lang, frozenset())
        self.stopwords = stopwords or frozenset()
        self.stem = stem
        self.accent_fold = accent_fold
        self.locale = lang
        self._stemmer = stemmer_for(lang) if stem else None

    def tokenize(self, text: str) -> list[Token]:
        norm = unicodedata.normalize("NFC", text).lower()
        out = []
        pos = 0
        for m in _WORD_RE.finditer(norm):
            raw = m.group()
            if _CJK_RE.search(raw):
                toks = _cjk_split(raw, pos, m.start())
                out.extend(toks)
                pos += len(toks) if toks else 1
                continue
            term = raw
            if term in self.stopwords:
                pos += 1
                continue
            if self.accent_fold:
                term = "".join(c for c in unicodedata.normalize("NFD", term)
                               if not unicodedata.combining(c))
            if term in self.stopwords:
                pos += 1
                continue
            if self._stemmer is not None:
                term = self._stemmer(term)
            out.append(Token(term, pos, m.start(), m.end()))
            pos += 1
        return out


class SimpleTextAnalyzer(TextAnalyzer):
    """text without stemming/stopwords — lowercase word split only."""

    name = "simple"

    def __init__(self):
        super().__init__(stopwords=frozenset(), stem=False)


class NgramAnalyzer(Analyzer):
    name = "ngram"

    def __init__(self, min_n: int = 2, max_n: int = 3, edge: bool = False):
        self.min_n, self.max_n, self.edge = min_n, max_n, edge

    def tokenize(self, text: str) -> list[Token]:
        t = text.lower()
        out = []
        pos = 0
        starts = [0] if self.edge else range(len(t))
        for i in starts:
            for n in range(self.min_n, self.max_n + 1):
                if i + n <= len(t):
                    out.append(Token(t[i:i + n], pos, i, i + n))
                    pos += 1
        return out


class DelimiterAnalyzer(Analyzer):
    name = "delimiter"

    def __init__(self, delimiter: str = ","):
        self.delimiter = delimiter

    def tokenize(self, text: str) -> list[Token]:
        out = []
        start = 0
        for pos, part in enumerate(text.split(self.delimiter)):
            out.append(Token(part, pos, start, start + len(part)))
            start += len(part) + len(self.delimiter)
        return out


class MultiDelimiterAnalyzer(Analyzer):
    """Split on any of several delimiters (reference:
    analysis/multi_delimited_tokenizer.cpp)."""

    name = "multi_delimiter"

    def __init__(self, delimiters: Iterable[str] = (",", ";")):
        ds = [re.escape(d) for d in delimiters if d]
        self._re = re.compile("|".join(ds)) if ds else None

    def tokenize(self, text: str) -> list[Token]:
        if self._re is None:
            return [Token(text, 0, 0, len(text))] if text else []
        out = []
        start = pos = 0
        for m in self._re.finditer(text):
            if m.start() > start:
                out.append(Token(text[start:m.start()], pos, start,
                                 m.start()))
                pos += 1
            start = m.end()
        if start < len(text):
            out.append(Token(text[start:], pos, start, len(text)))
        return out


class SegmentationAnalyzer(Analyzer):
    """Unicode word-boundary segmentation with case control (reference:
    analysis/segmentation_tokenizer.cpp; break='word'|'alpha'|'graphic',
    case='lower'|'upper'|'none')."""

    name = "segmentation"

    def __init__(self, break_mode: str = "alpha", case: str = "lower"):
        if break_mode not in ("word", "alpha", "graphic"):
            raise errors.SqlError("22023",
                                  f"unknown break option {break_mode!r}")
        if case not in ("lower", "upper", "none"):
            raise errors.SqlError("22023", f"unknown case option {case!r}")
        self.break_mode = break_mode
        self.case = case

    def tokenize(self, text: str) -> list[Token]:
        if self.case == "lower":
            text = text.lower()
        elif self.case == "upper":
            text = text.upper()
        pat = {"word": r"\w+", "alpha": r"\w+",
               "graphic": r"\S+"}[self.break_mode]
        out = []
        pos = 0
        for m in re.finditer(pat, text, re.UNICODE):
            raw = m.group()
            if self.break_mode == "alpha" and raw.isdigit():
                continue
            if _CJK_RE.search(raw):
                toks = _cjk_split(raw, pos, m.start())
                out.extend(toks)
                pos += len(toks) if toks else 1
                continue
            out.append(Token(raw, pos, m.start(), m.end()))
            pos += 1
        return out


class NormalizingAnalyzer(Analyzer):
    """Whole-input normalization, no split (reference:
    analysis/normalizing_tokenizer.cpp): case fold + optional accent
    removal, emits one token."""

    name = "norm"

    def __init__(self, case: str = "lower", accent: bool = False):
        self.case = case
        self.accent = accent

    def tokenize(self, text: str) -> list[Token]:
        t = unicodedata.normalize("NFC", text)
        if self.case == "lower":
            t = t.lower()
        elif self.case == "upper":
            t = t.upper()
        if not self.accent:
            t = "".join(c for c in unicodedata.normalize("NFD", t)
                        if not unicodedata.combining(c))
        return [Token(t, 0, 0, len(text))] if t else []


class CollationAnalyzer(Analyzer):
    """Collation sort-key token (reference:
    analysis/collation_tokenizer.cpp): emits a locale-insensitive sort key
    so ORDER BY / range filters over the index agree with a case/accent
    -insensitive collation. Approximated as NFKD casefold with marks
    stripped — correct for the Latin-script locales this build targets."""

    name = "collation"

    def __init__(self, locale: str = "en"):
        self.locale = _lang_of(locale)

    def tokenize(self, text: str) -> list[Token]:
        key = "".join(c for c in unicodedata.normalize("NFKD",
                                                       text.casefold())
                      if not unicodedata.combining(c))
        return [Token(key, 0, 0, len(text))]


class StemAnalyzer(Analyzer):
    """Whole-input stemmer (reference: analysis/stemming_tokenizer.cpp):
    lowercases and stems the input as a single token."""

    name = "stem"

    def __init__(self, locale: str = "en"):
        self.locale = _lang_of(locale)
        self._stemmer = stemmer_for(self.locale) or (lambda w: w)

    def tokenize(self, text: str) -> list[Token]:
        t = self._stemmer(text.strip().lower())
        return [Token(t, 0, 0, len(text))] if t else []


class PatternAnalyzer(Analyzer):
    """Regex tokenizer (reference: analysis/pattern_tokenizer.cpp):
    mode='match' emits every match of the pattern (group 1 if present),
    mode='split' uses the pattern as a separator."""

    name = "pattern"

    def __init__(self, pattern: str, mode: str = "match",
                 case: str = "none"):
        if mode not in ("match", "split"):
            raise errors.SqlError("22023", f"unknown pattern mode {mode!r}")
        try:
            self._re = re.compile(pattern)
        except re.error as e:
            raise errors.SqlError("2201B", f"invalid regex: {e}")
        self.mode = mode
        self.case = case

    def tokenize(self, text: str) -> list[Token]:
        if self.case == "lower":
            text = text.lower()
        elif self.case == "upper":
            text = text.upper()
        out = []
        if self.mode == "match":
            for pos, m in enumerate(self._re.finditer(text)):
                term = m.group(1) if self._re.groups else m.group()
                if term:
                    out.append(Token(term, pos, m.start(), m.end()))
        else:
            start = pos = 0
            for m in self._re.finditer(text):
                if m.end() == m.start():
                    continue   # zero-width separators split nothing
                if m.start() > start:
                    out.append(Token(text[start:m.start()], pos, start,
                                     m.start()))
                    pos += 1
                start = m.end()
            if start < len(text):
                out.append(Token(text[start:], pos, start, len(text)))
        return out


class PathHierarchyAnalyzer(Analyzer):
    """Path prefixes (reference: analysis/path_hierarchy_tokenizer.cpp):
    '/a/b/c' → '/a', '/a/b', '/a/b/c' (all at position 0, like the
    reference — a path filter matches any ancestor)."""

    name = "path_hierarchy"

    def __init__(self, delimiter: str = "/", reverse: bool = False):
        self.delimiter = delimiter
        self.reverse = reverse

    def tokenize(self, text: str) -> list[Token]:
        d = self.delimiter
        parts = [p for p in text.split(d) if p != ""]
        if not parts:
            return []
        out = []
        if not self.reverse:
            lead = d if text.startswith(d) else ""
            for i in range(1, len(parts) + 1):
                term = lead + d.join(parts[:i])
                out.append(Token(term, 0, 0, len(term)))
        else:
            trail = d if text.endswith(d) else ""
            for i in range(len(parts)):
                term = d.join(parts[i:]) + trail
                out.append(Token(term, 0, len(text) - len(term), len(text)))
        return out


class SynonymAnalyzer(Analyzer):
    """Synonym expansion over an inner analyzer (reference:
    analysis/solr_synonyms_tokenizer.cpp / wordnet_synonyms_tokenizer.cpp).
    Mapping 'a => b,c' (solr style) or symmetric groups 'a,b,c'; expansions
    are emitted AT THE SAME POSITION so phrase queries still line up."""

    name = "synonyms"

    def __init__(self, rules: Iterable[str],
                 inner: Optional[Analyzer] = None):
        self.inner = inner or SimpleTextAnalyzer()
        self.map: dict[str, list[str]] = {}
        for rule in rules:
            rule = rule.strip()
            if not rule or rule.startswith("#"):
                continue
            if "=>" in rule:
                lhs, rhs = rule.split("=>", 1)
                targets = [t.strip().lower() for t in rhs.split(",")
                           if t.strip()]
                for src in lhs.split(","):
                    src = src.strip().lower()
                    if src:
                        self.map.setdefault(src, []).extend(
                            t for t in targets
                            if t not in self.map.get(src, []))
            else:
                group = [t.strip().lower() for t in rule.split(",")
                         if t.strip()]
                for src in group:
                    self.map.setdefault(src, []).extend(
                        t for t in group
                        if t != src and t not in self.map.get(src, []))

    def tokenize(self, text: str) -> list[Token]:
        out = []
        for tok in self.inner.tokenize(text):
            out.append(tok)
            for syn in self.map.get(tok.term.lower(), ()):
                out.append(Token(syn, tok.position, tok.start, tok.end))
        return out


class PipelineAnalyzer(Analyzer):
    """Chain analyzers: each stage re-tokenizes the previous stage's terms
    (reference: analysis/pipeline_tokenizer.cpp). Positions compose so a
    delimiter → text pipeline keeps phrase semantics."""

    name = "pipeline"

    def __init__(self, stages: list[Analyzer]):
        if not stages:
            raise errors.SqlError("22023", "pipeline requires stages")
        self.stages = stages

    def tokenize(self, text: str) -> list[Token]:
        toks = self.stages[0].tokenize(text)
        for stage in self.stages[1:]:
            nxt: list[Token] = []
            pos = 0
            for t in toks:
                subs = stage.tokenize(t.term)
                for s in subs:
                    nxt.append(Token(s.term, pos, t.start, t.end))
                    pos += 1
                if not subs:
                    pos += 1
            toks = nxt
        return toks


class UnionAnalyzer(Analyzer):
    """Union of several analyzers' outputs, deduplicated by (term,
    position) (reference: analysis/union_tokenizer.cpp — e.g. exact +
    stemmed forms indexed together)."""

    name = "union"

    def __init__(self, parts: list[Analyzer]):
        if not parts:
            raise errors.SqlError("22023", "union requires analyzers")
        self.parts = parts

    def tokenize(self, text: str) -> list[Token]:
        seen = set()
        out = []
        for a in self.parts:
            for t in a.tokenize(text):
                key = (t.term, t.position)
                if key not in seen:
                    seen.add(key)
                    out.append(t)
        return out


class MinHashAnalyzer(Analyzer):
    """MinHash signature tokens (reference: analysis/minhash_tokenizer.cpp):
    k minimal 64-bit hashes over the inner analyzer's term shingles —
    near-duplicate detection with |sig∩sig'|/k ≈ Jaccard similarity."""

    name = "minhash"

    def __init__(self, k: int = 32, inner: Optional[Analyzer] = None,
                 shingle: int = 3):
        self.k = int(k)
        self.inner = inner or SimpleTextAnalyzer()
        self.shingle = max(1, int(shingle))

    def tokenize(self, text: str) -> list[Token]:
        import hashlib
        terms = [t.term for t in self.inner.tokenize(text)]
        if not terms:
            return []
        n = self.shingle
        shingles = ({" ".join(terms[i:i + n])
                     for i in range(max(1, len(terms) - n + 1))}
                    if len(terms) >= 1 else set())
        hashes = sorted(
            int.from_bytes(
                hashlib.blake2b(s.encode(), digest_size=8).digest(),
                "big")
            for s in shingles)[: self.k]
        return [Token(format(h, "016x"), i, 0, 0)
                for i, h in enumerate(hashes)]


class ClassificationAnalyzer(Analyzer):
    """Model-backed classification analyzer (reference:
    analysis/classification_stream.cpp — fastText emits the model's
    top-k predicted labels as tokens). The model here is a centroid
    classifier over the deterministic local char-trigram embedding
    (functions/embedfns.local_embed): each label's centroid is the mean
    embedding of its example texts (the label name itself is always
    included, so querying by label is stable). tokenize() emits the
    top-k label names as tokens."""

    name = "classification"

    def __init__(self, labels: dict[str, str], top: int = 1,
                 dim: int = 64):
        import numpy as _np

        from ..functions.embedfns import local_embed
        if not labels:
            raise errors.SqlError(
                "22023", "classification tokenizer needs labels")
        self._embed = local_embed
        self.top = max(1, int(top))
        self.dim = int(dim)
        self.label_names = sorted(labels)
        cents = []
        for lab in self.label_names:
            examples = [lab] + [w for w in str(labels[lab]).split() if w]
            m = _np.stack([local_embed(e, self.dim) for e in examples])
            c = m.mean(axis=0)
            n = float((c * c).sum()) ** 0.5
            cents.append(c / n if n > 0 else c)
        self._centroids = _np.stack(cents)

    def classify(self, text: str) -> list[str]:
        sims = self._centroids @ self._embed(text, self.dim)
        order = sims.argsort()[::-1][: self.top]
        return [self.label_names[i] for i in order]

    def tokenize(self, text: str) -> list[Token]:
        if not text or not text.strip():
            return []
        return [Token(lab, i, 0, len(text))
                for i, lab in enumerate(self.classify(text))]


class NearestNeighborsAnalyzer(Analyzer):
    """Model-backed term-expansion analyzer (reference:
    analysis/nearest_neighbors_stream.cpp — fastText emits each token's
    nearest model terms). Vocabulary words are embedded with the local
    char-trigram model; each input token (tokenized by `inner`) is
    replaced by its top-k nearest vocabulary terms, emitted at the
    token's position (synonym-style expansion)."""

    name = "nearest_neighbors"

    def __init__(self, vocab: list[str], top: int = 2, dim: int = 64,
                 inner: Optional[Analyzer] = None):
        import numpy as _np

        from ..functions.embedfns import local_embed
        vocab = [w for w in vocab if w]
        if not vocab:
            raise errors.SqlError(
                "22023", "nearest_neighbors tokenizer needs a vocabulary")
        self._embed = local_embed
        self.top = max(1, int(top))
        self.dim = int(dim)
        self.inner = inner or SimpleTextAnalyzer()
        self.vocab = sorted(set(w.lower() for w in vocab))
        self._matrix = _np.stack(
            [local_embed(w, self.dim) for w in self.vocab])
        self._memo: dict[str, list[str]] = {}

    def neighbors(self, term: str) -> list[str]:
        # terms repeat heavily (Zipf) and this sits on the ingest hot
        # path — memoize per distinct term
        hit = self._memo.get(term)
        if hit is not None:
            return hit
        sims = self._matrix @ self._embed(term, self.dim)
        order = sims.argsort()[::-1][: self.top]
        out = [self.vocab[i] for i in order]
        if len(self._memo) < 1_000_000:
            self._memo[term] = out
        return out

    def tokenize(self, text: str) -> list[Token]:
        out = []
        for t in self.inner.tokenize(text):
            for nb in self.neighbors(t.term):
                out.append(Token(nb, t.position, t.start, t.end))
        return out


_BUILTINS: dict[str, Callable[[], Analyzer]] = {
    "keyword": KeywordAnalyzer,
    "whitespace": WhitespaceAnalyzer,
    "text": TextAnalyzer,
    "simple": SimpleTextAnalyzer,
    "ngram": NgramAnalyzer,
    "edge_ngram": lambda: NgramAnalyzer(edge=True),
    "delimiter": DelimiterAnalyzer,
    "multi_delimiter": MultiDelimiterAnalyzer,
    "segmentation": SegmentationAnalyzer,
    "norm": NormalizingAnalyzer,
    "collation": CollationAnalyzer,
    "stem": StemAnalyzer,
    "path_hierarchy": PathHierarchyAnalyzer,
    "minhash": MinHashAnalyzer,
}
# locale text analyzers: text_en … text_fi (reference registers per-locale
# text tokenizers the same way)
for _lang in ("en", "de", "fr", "es", "it", "pt", "nl", "ru", "sv", "fi",
              "da", "no", "ro", "tr", "hu"):
    _BUILTINS[f"text_{_lang}"] = (
        lambda _l=_lang: TextAnalyzer(locale=_l))

_cache: dict[str, Analyzer] = {}
_custom: dict[str, Analyzer] = {}


_KNOWN_DICT_OPTIONS = {
    # behavioral
    "template", "stemming", "accent", "stopwords", "min", "max",
    "delimiter", "delimiters", "locale", "case", "break", "pattern",
    "mode", "synonyms", "stages", "analyzers", "hashes", "shingle",
    "reverse", "analyzer",
    # model-backed analyzers
    "labels", "top", "vocab", "dim",
    # accepted reference options that are defaults/no-ops here
    "frequency", "position", "norm",
}


def register_dictionary(name: str, options: dict,
                        if_not_exists: bool = False,
                        replace: bool = False) -> Analyzer:
    """CREATE TEXT SEARCH DICTIONARY: a named, configured analyzer
    (reference: server/pg/commands/create_tsdictionary.cpp; template/
    case/stemming/accent options as in examples/demo0/demo.sql).

    Dictionaries may not shadow builtin analyzer names, and duplicates
    error unless IF NOT EXISTS / replace (recovery) is given."""
    key = name.lower()
    unknown = set(options) - _KNOWN_DICT_OPTIONS
    if unknown:
        raise errors.SqlError(
            "22023", f"unrecognized dictionary option "
                     f"{sorted(unknown)[0]!r}")
    if key in _BUILTINS:
        raise errors.SqlError(errors.DUPLICATE_OBJECT,
                              f'"{name}" is a builtin tokenizer')
    if key in _custom and not replace:
        if if_not_exists:
            return _custom[key]
        raise errors.SqlError(errors.DUPLICATE_OBJECT,
                              f'text search dictionary "{name}" already '
                              "exists")
    template = str(options.get("template", "text")).lower()
    def truthy(v, default):
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).lower() in ("true", "on", "1", "yes")
    locale = str(options.get("locale", "en"))
    if template in ("text", "simple"):
        want_stop = truthy(options.get("stopwords"), False)
        # reference contract (text_tokenizer.hpp:61, normalizing_
        # tokenizer.hpp:49): accent=true KEEPS accents, accent=false /
        # unset removes them
        a = TextAnalyzer(
            stopwords=(None if want_stop else frozenset()),
            stem=truthy(options.get("stemming"), template == "text"),
            accent_fold=not truthy(options.get("accent"), False),
            locale=locale)
    elif template == "whitespace":
        a = WhitespaceAnalyzer()
    elif template == "keyword":
        a = KeywordAnalyzer()
    elif template in ("ngram", "edge_ngram"):
        a = NgramAnalyzer(int(options.get("min", 2)),
                          int(options.get("max", 3)),
                          edge=template == "edge_ngram")
    elif template == "delimiter":
        a = DelimiterAnalyzer(str(options.get("delimiter", ",")))
    elif template == "multi_delimiter":
        ds = options.get("delimiters", ",;")
        if isinstance(ds, str):
            ds = list(ds)
        a = MultiDelimiterAnalyzer(ds)
    elif template == "segmentation":
        a = SegmentationAnalyzer(
            break_mode=str(options.get("break", "alpha")).lower(),
            case=str(options.get("case", "lower")).lower())
    elif template == "norm":
        a = NormalizingAnalyzer(
            case=str(options.get("case", "lower")).lower(),
            accent=truthy(options.get("accent"), False))
    elif template == "collation":
        a = CollationAnalyzer(locale)
    elif template == "stem":
        a = StemAnalyzer(locale)
    elif template == "pattern":
        a = PatternAnalyzer(str(options.get("pattern", r"\w+")),
                            mode=str(options.get("mode", "match")).lower(),
                            case=str(options.get("case", "none")).lower())
    elif template == "path_hierarchy":
        a = PathHierarchyAnalyzer(
            str(options.get("delimiter", "/")),
            reverse=truthy(options.get("reverse"), False))
    elif template == "synonyms":
        rules = options.get("synonyms", "")
        if isinstance(rules, str):
            rules = [r for r in re.split(r"[\n;]", rules) if r.strip()]
        inner = get_analyzer(str(options.get("analyzer", "simple")))
        a = SynonymAnalyzer(rules, inner)
    elif template == "pipeline":
        names = options.get("stages", "")
        stage_names = ([s.strip() for s in names.split(",") if s.strip()]
                       if isinstance(names, str) else list(names))
        a = PipelineAnalyzer([get_analyzer(s) for s in stage_names])
    elif template == "union":
        names = options.get("analyzers", "")
        part_names = ([s.strip() for s in names.split(",") if s.strip()]
                      if isinstance(names, str) else list(names))
        a = UnionAnalyzer([get_analyzer(s) for s in part_names])
    elif template == "minhash":
        a = MinHashAnalyzer(
            k=int(options.get("hashes", 32)),
            inner=get_analyzer(str(options.get("analyzer", "simple"))),
            shingle=int(options.get("shingle", 3)))
    elif template == "classification":
        raw = options.get("labels", "")
        labels: dict[str, str] = {}
        if isinstance(raw, dict):
            labels = {str(k).strip().lower(): str(v)
                      for k, v in raw.items()}
        else:
            # "sports: football goal; tech: compiler kernel"
            for part in re.split(r"[;\n]", str(raw)):
                lab, _, examples = part.partition(":")
                if lab.strip():
                    labels[lab.strip().lower()] = examples.strip()
        a = ClassificationAnalyzer(labels,
                                   top=int(options.get("top", 1)),
                                   dim=int(options.get("dim", 64)))
    elif template == "nearest_neighbors":
        raw = options.get("vocab", "")
        vocab = ([str(w) for w in raw] if isinstance(raw, (list, tuple))
                 else re.split(r"[\s,;]+", str(raw)))
        a = NearestNeighborsAnalyzer(
            vocab, top=int(options.get("top", 2)),
            dim=int(options.get("dim", 64)),
            inner=get_analyzer(str(options.get("analyzer", "simple"))))
    else:
        raise errors.SqlError(errors.UNDEFINED_OBJECT,
                              f'tokenizer template "{template}" does not '
                              "exist")
    a.name = name.lower()
    _custom[name.lower()] = a
    return a


def dictionary_exists(name: str) -> bool:
    return name.lower() in _custom


def drop_dictionary(name: str) -> bool:
    return _custom.pop(name.lower(), None) is not None


def get_analyzer(name: str) -> Analyzer:
    key = (name or "text").lower()
    a = _custom.get(key)
    if a is not None:
        return a
    a = _cache.get(key)
    if a is None:
        ctor = _BUILTINS.get(key)
        if ctor is None:
            raise errors.SqlError(errors.UNDEFINED_OBJECT,
                                  f'tokenizer "{name}" does not exist')
        a = _cache[key] = ctor()
    return a


def default_analyzer() -> Analyzer:
    return get_analyzer("text")
